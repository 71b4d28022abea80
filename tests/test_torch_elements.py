"""Lagrange tabulation, quadrature rules and local dof counts of the port
against the JAX package's, on intervals and triangles, P1 and P2. Both are
the same float64 numpy arithmetic, so they agree to 1e-15 (in practice
bit for bit)."""

import numpy as np
import pytest

from fedm_tpu.fem import elements as jel
from fedm_tpu_torch.fem import elements as tel

TOL = 1e-15
CELLS = [("interval", 1), ("interval", 2), ("triangle", 1), ("triangle", 2)]


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert np.shape(got) == np.shape(ref)


@pytest.mark.parametrize("cell,degree", CELLS,
                         ids=[f"{c}-P{d}" for c, d in CELLS])
def test_n_local_dofs(cell, degree):
    assert tel.n_local_dofs(cell, degree) == jel.n_local_dofs(cell, degree)


@pytest.mark.parametrize("cell,degree", CELLS,
                         ids=[f"{c}-P{d}" for c, d in CELLS])
def test_tabulate_at_random_points(cell, degree):
    rng = np.random.default_rng(7)
    dim = 1 if cell == "interval" else 2
    pts = rng.random((11, dim))
    if dim == 2:  # inside the reference triangle
        pts = np.where(pts.sum(1, keepdims=True) > 1, 1 - pts, pts)
    N, dN = tel.tabulate(cell, degree, pts)
    jN, jdN = jel.tabulate(cell, degree, pts)
    _close(N, jN)
    _close(dN, jdN)
    # a partition of unity whose gradients sum to zero
    np.testing.assert_allclose(N.sum(1), 1.0, rtol=1e-14)
    np.testing.assert_allclose(dN.sum(1), 0.0, atol=1e-13)


@pytest.mark.parametrize("cell,degree", CELLS,
                         ids=[f"{c}-P{d}" for c, d in CELLS])
def test_tabulate_is_nodal(cell, degree):
    """N_a(x_b) = delta_ab at the local dofs, in the documented order
    (vertices, then edge midpoints with edge i opposite vertex i)."""
    if cell == "interval":
        nodes = np.array([[0.0], [1.0], [0.5]])[:degree + 1]
    else:
        nodes = np.array([[0, 0], [1, 0], [0, 1], [0.5, 0.5], [0, 0.5],
                          [0.5, 0]], dtype=float)[:3 * degree]
    N, _ = tel.tabulate(cell, degree, nodes)
    np.testing.assert_allclose(N, np.eye(len(nodes)), atol=1e-15)
    _close(N, jel.tabulate(cell, degree, nodes)[0])


@pytest.mark.parametrize("cell", ["interval", "triangle"])
@pytest.mark.parametrize("degree", range(0, 9))
def test_cell_quadrature(cell, degree):
    pts, wts = tel.cell_quadrature(cell, degree)
    jpts, jwts = jel.cell_quadrature(cell, degree)
    _close(pts, jpts)
    _close(wts, jwts)


@pytest.mark.parametrize("cell_dim", [1, 2])
@pytest.mark.parametrize("degree", range(1, 7))
def test_facet_quadrature(cell_dim, degree):
    pts, wts = tel.facet_quadrature(cell_dim, degree)
    jpts, jwts = jel.facet_quadrature(cell_dim, degree)
    _close(pts, jpts)
    _close(wts, jwts)


@pytest.mark.parametrize("call", [
    lambda m: m.n_local_dofs("square", 1),
    lambda m: m.tabulate("interval", 3, [[0.5]]),
    lambda m: m.tabulate("triangle", 3, [[0.2, 0.2]]),
    lambda m: m.tabulate("square", 1, [[0.2, 0.2]]),
    lambda m: m.cell_quadrature("square", 2),
], ids=["n_local", "interval-P3", "triangle-P3", "tabulate-cell",
        "quadrature-cell"])
def test_what_the_jax_package_refuses_is_refused(call):
    for m in (jel, tel):
        with pytest.raises((ValueError, KeyError)):
            call(m)
