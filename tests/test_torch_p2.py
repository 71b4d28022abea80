"""1D meshes, P2 spaces and the generalised cell and facet batches of the
port against the JAX package: interval P1/P2 and triangle P1/P2 (the
time-of-flight runs use interval P2 and triangle P1).

Host-side tables (mesh, dofs, geometry) are the same numpy arithmetic in
both packages and must agree exactly or to 1e-15; device-side assembly
(einsums, scatters, the CG of `project`) is compared in float64 to 1e-13
relative (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.fem import CellBatch as JCell
from fedm_tpu.fem import FacetBatch as JFacet
from fedm_tpu.fem import FunctionSpace as JSpace
from fedm_tpu.fem import interpolate as jinterpolate
from fedm_tpu.fem import project as jproject
from fedm_tpu.fem import vector_l2_norm as jnorm
from fedm_tpu.fem.dirichlet import DirichletBC as JBC
from fedm_tpu.fem.dirichlet import combine_bcs as jcombine
from fedm_tpu.mesh import interval_mesh as jinterval
from fedm_tpu.mesh import mesh_info as jmesh_info
from fedm_tpu.mesh import rectangle_mesh as jrect
from fedm_tpu_torch.fem import (CellBatch, DirichletBC, FacetBatch,
                                FunctionSpace, combine_bcs, interpolate,
                                project, vector_l2_norm)
from fedm_tpu_torch.mesh import interval_mesh, mesh_info, rectangle_mesh

RTOL = 1e-13
CASES = {
    "interval-P1": (lambda m: m(9, 0.0, 1e-3), 1),
    "interval-P2": (lambda m: m(9, 0.0, 1e-3), 2),
    "triangle-P1": (lambda m: m((0, 0), (2.5e-4, 5e-4), 4, 3), 1),
    "triangle-P2": (lambda m: m((0, 0), (1.0, 2.0), 4, 3), 2),
    "crossed-P2": (lambda m: m((0, 0), (1.0, 1.0), 3, 2, "crossed"), 2),
}


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _spaces(name):
    make, degree = CASES[name]
    gen = (jinterval, interval_mesh) if name.startswith("interval") else (
        jrect, rectangle_mesh)
    return (JSpace(make(gen[0]), degree), FunctionSpace(make(gen[1]),
                                                        degree))


@pytest.fixture(params=list(CASES))
def spaces(request):
    return _spaces(request.param)


def test_interval_mesh():
    a, b = jinterval(7, 0.0, 1e-3), interval_mesh(7, 0.0, 1e-3)
    assert b.dim == a.dim == 1
    for f in ("coords", "cells", "boundary_facets", "boundary_cells",
              "facet_markers"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f))
    for f in ("cell_h", "cell_extents", "facet_normals", "facet_midpoints"):
        np.testing.assert_array_equal(getattr(b, f)(), getattr(a, f)())
    np.testing.assert_array_equal(b.facet_normals()[:, 0], [-1.0, 1.0])
    assert (b.hmax(), b.hmin()) == (a.hmax(), a.hmin())
    assert mesh_info(b) == jmesh_info(a)


def test_triangle_mesh_metrics():
    a = jrect((0, 0), (2.5e-4, 5e-4), 40, 40)
    b = rectangle_mesh((0, 0), (2.5e-4, 5e-4), 40, 40)
    assert b.dim == 2 and (b.hmax(), b.hmin()) == (a.hmax(), a.hmin())
    np.testing.assert_array_equal(b.facet_midpoints(), a.facet_midpoints())
    assert mesh_info(b) == jmesh_info(a)


def test_space_dofs(spaces):
    js, ts = spaces
    assert (ts.n_dofs, ts.n_local, ts.cell_type) == (js.n_dofs, js.n_local,
                                                     js.cell_type)
    np.testing.assert_array_equal(ts.cell_dofs, js.cell_dofs)
    np.testing.assert_array_equal(ts.dof_coords, js.dof_coords)
    np.testing.assert_array_equal(ts.boundary_dofs(), js.boundary_dofs())
    mask = np.arange(len(ts.mesh.boundary_facets)) % 2 == 0
    np.testing.assert_array_equal(ts.boundary_dofs(mask),
                                  js.boundary_dofs(mask))
    pred = lambda x: x[:, -1] > 0.5 * x[:, -1].max()  # noqa: E731
    np.testing.assert_array_equal(ts.dofs_where(pred), js.dofs_where(pred))


def test_p2_counts():
    s1 = FunctionSpace(interval_mesh(4000, 0.0, 1e-3), 2)
    assert s1.n_dofs == 8001 and s1.cell_dofs.shape == (4000, 3)
    s2 = FunctionSpace(rectangle_mesh((0, 0), (1, 1), 4, 3), 2)
    # vertices + unique edges: 20 + (4*4 + 5*3 + 12) = 63
    assert s2.n_dofs == 63 and s2.cell_dofs.shape == (24, 6)
    # every boundary edge dof lies on the boundary
    x = s2.dof_coords[s2.boundary_dofs()]
    on = (np.isclose(x, 0) | np.isclose(x, 1)).any(axis=1)
    assert on.all() and len(x) == 2 * (4 + 3) * 2


@pytest.mark.parametrize("axisymmetric", [False, True],
                         ids=["planar", "axisymmetric"])
def test_cell_tables(spaces, axisymmetric):
    js, ts = spaces
    jb = JCell(js, quad_degree=6, axisymmetric=axisymmetric)
    tb = CellBatch(ts, quad_degree=6, axisymmetric=axisymmetric,
                   device="cpu")
    assert tb.grads.shape[1] == (1 if ts.degree == 1 else tb.n_q)
    for f in ("N", "grads", "scale", "x_q", "h", "h_dir"):
        _close(getattr(tb, f), getattr(jb, f), 1e-15)
    np.testing.assert_array_equal(tb.dofs.numpy(), np.asarray(jb.dofs))
    # structured assembly: P1 triangles of the `right` layout only
    assert tb.try_structured() == jb.try_structured() == (
        ts.degree == 1 and ts.cell_type == "triangle")


def test_facet_tables(spaces):
    js, ts = spaces
    jf = JFacet(js, markers=None, quad_degree=4, axisymmetric=True)
    tf = FacetBatch(ts, markers=None, quad_degree=4, axisymmetric=True,
                    device="cpu")
    assert tf.n_facets == jf.n_facets == len(ts.mesh.boundary_facets)
    for f in ("N", "grads", "scale", "normal", "x_q"):
        _close(getattr(tf, f), getattr(jf, f), 1e-15)
    np.testing.assert_array_equal(tf.dofs.numpy(), np.asarray(jf.dofs))


@pytest.mark.parametrize("trailing", [(), (2,)], ids=["scalar", "n_eq"])
def test_cell_operations(spaces, trailing):
    js, ts = spaces
    jb = JCell(js, quad_degree=4, axisymmetric=False)
    tb = CellBatch(ts, quad_degree=4, device="cpu")
    n, q, nl, dim = tb.dofs.shape[0], tb.n_q, tb.n_local, ts.mesh.dim
    rng = np.random.default_rng(3)
    u = rng.standard_normal((ts.n_dofs,) + trailing)
    ue = rng.standard_normal((n, nl) + trailing)
    s = rng.standard_normal((n, q) + trailing)
    G = rng.standard_normal((n, q, dim) + trailing)
    c = rng.standard_normal((n, nl) + trailing)
    T = torch.as_tensor
    _close(tb.gather(T(u)), jb.gather(jnp.asarray(u)))
    _close(tb.value(T(ue)), jb.value(jnp.asarray(ue)))
    _close(tb.grad(T(ue)), jb.grad(jnp.asarray(ue)))
    _close(tb.mass(T(s)), jb.mass(jnp.asarray(s)))
    _close(tb.stiffness(T(G)), jb.stiffness(jnp.asarray(G)))
    _close(tb.integrate(T(s)), jb.integrate(jnp.asarray(s)))
    _close(tb.scatter(T(c)), jb.scatter(jnp.asarray(c)))
    out = T(u.copy())
    _close(tb.scatter_add(out, T(c)), u + np.asarray(jb.scatter(
        jnp.asarray(c))))


def test_facet_operations(spaces):
    js, ts = spaces
    jf = JFacet(js, markers=None, quad_degree=4)
    tf = FacetBatch(ts, markers=None, quad_degree=4, device="cpu")
    n, q, nl = tf.dofs.shape[0], tf.n_q, tf.n_local
    rng = np.random.default_rng(4)
    u = rng.standard_normal(ts.n_dofs)
    ue = rng.standard_normal((n, nl))
    s = rng.standard_normal((n, q))
    T = torch.as_tensor
    _close(tf.gather(T(u)), jf.gather(jnp.asarray(u)))
    _close(tf.value(T(ue)), jf.value(jnp.asarray(ue)))
    _close(tf.grad(T(ue)), jf.grad(jnp.asarray(ue)))
    _close(tf.mass(T(s)), jf.mass(jnp.asarray(s)))
    _close(tf.integrate(T(s)), jf.integrate(jnp.asarray(s)))
    _close(tf.scatter(T(ue)), jf.scatter(jnp.asarray(ue)))


@pytest.mark.parametrize("lumped", [False, True], ids=["cg", "lumped"])
@pytest.mark.parametrize("name", ["interval-P1", "interval-P2",
                                  "triangle-P1"])
def test_project(name, lumped):
    js, ts = _spaces(name)
    axi = ts.mesh.dim == 2  # r = x[0] starts at 0: planar in 1D
    jb = JCell(js, quad_degree=4, axisymmetric=axi)
    tb = CellBatch(ts, quad_degree=4, axisymmetric=axi, device="cpu")
    x = np.asarray(jb.x_q)
    s = np.exp(-((x[..., -1] - x[..., -1].mean()) / x[..., -1].std()) ** 2)
    _close(project(torch.as_tensor(s), tb, lumped=lumped),
           jproject(jnp.asarray(s), jb, lumped=lumped), 1e-12)


@pytest.mark.parametrize("name", ["triangle-P2", "crossed-P2"])
def test_project_on_triangle_p2_has_no_lumped_diagonal(name):
    """On quadratic triangles a vertex's shape function integrates to 0,
    so the lumped mass that `project` divides by (its Jacobi
    preconditioner and its `lumped` answer) vanishes at the vertices, in
    both packages alike: `project` is for P1 triangles and intervals."""
    js, ts = _spaces(name)
    jb = JCell(js, quad_degree=4)
    tb = CellBatch(ts, quad_degree=4, device="cpu")
    lump = tb.scatter(tb.mass(torch.ones_like(tb.scale))).numpy()
    jlump = np.asarray(jb.scatter(jb.mass(jnp.ones_like(jb.scale))))
    nv = ts.mesh.n_verts
    for lu in (lump, jlump):
        assert np.abs(lu[:nv]).max() < 1e-15 * lu[nv:].max()
    _close(lump[nv:], jlump[nv:])


def test_interpolate_and_norm(spaces):
    js, ts = spaces

    def fn(x):
        return np.sin(x[:, 0] * 3e3) + x[:, -1] ** 2

    got = interpolate(fn, ts, device="cpu")
    ref = jinterpolate(fn, js)
    _close(got, ref, 0)
    _close(interpolate(2.5, ts, device="cpu"), jinterpolate(2.5, js), 0)
    _close(interpolate(lambda x: 1.5, ts, device="cpu"),
           jinterpolate(lambda x: 1.5, js), 0)
    u = np.random.default_rng(5).standard_normal((ts.n_dofs, 3))
    _close(vector_l2_norm(torch.as_tensor(u)), jnorm(jnp.asarray(u)))


def test_combine_bcs_on_boundary_dofs(spaces):
    js, ts = spaces
    half = np.arange(len(ts.mesh.boundary_facets)) < len(
        ts.mesh.boundary_facets) // 2
    d0, d1 = ts.boundary_dofs(half), ts.boundary_dofs(~half)
    vals = np.linspace(1.0, 2.0, len(d1))
    tb = combine_bcs(ts, 2, [DirichletBC(d0, 0, 3.0),
                             DirichletBC(d1, 1, vals),
                             DirichletBC(d0, 1, lambda t: 1e9 * t)],
                     device="cpu")
    jb = jcombine(js, 2, [JBC(d0, 0, 3.0), JBC(d1, 1, vals),
                          JBC(d0, 1, lambda t: 1e9 * t)])
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    for t in (0.0, 2e-9):
        np.testing.assert_array_equal(tb.values_at(t).numpy(),
                                      np.asarray(jb.values(t)))


def test_normal_vector(spaces):
    from fedm_tpu.fem.postprocess import normal_vector as jnormal
    from fedm_tpu_torch.fem.postprocess import normal_vector

    js, ts = spaces
    got = normal_vector(ts, device="cpu")
    _close(got, jnormal(js), 1e-10)
    assert got.shape == (ts.n_dofs, ts.mesh.dim)


@pytest.mark.parametrize("name", ["triangle-P1", "interval-P2"])
def test_boundary_gradient(name):
    from fedm_tpu.fem.postprocess import boundary_gradient as jbg
    from fedm_tpu_torch.fem.postprocess import boundary_gradient

    js, ts = _spaces(name)
    jb = JCell(js, quad_degree=4)
    tb = CellBatch(ts, quad_degree=4, device="cpu")
    x = ts.dof_coords
    var = 1e3 * (x[:, -1] / x[:, -1].max()) ** 2
    src = np.full(tb.scale.shape, 2e-6)
    got = boundary_gradient(tb, ts, torch.as_tensor(var),
                            torch.as_tensor(src), 0)
    ref = jbg(jb, js, jnp.asarray(var), jnp.asarray(src), 0)
    _close(got, ref, 1e-9)
