"""Mesh, elements, Dirichlet masks and batched assembly of the port against
the JAX package, on the small corridor streamer configuration of
tests/unit/test_geom_mode.py and on the bench's coordinate lines.

Host-side geometry is computed by the same numpy arithmetic in both
packages, so it must agree exactly; device-side assembly is compared in
float64 to 1e-13 relative (summation order only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.fem.elements import cell_quadrature as jax_cell_quadrature
from fedm_tpu.fem.elements import facet_quadrature as jax_facet_quadrature
from fedm_tpu.fem.elements import tabulate as jax_tabulate
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu_torch.fem.elements import (cell_quadrature, facet_quadrature,
                                         tabulate)
from fedm_tpu_torch.models import streamer as port_streamer
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel

SMALL = dict(z_corridor=(7e-3, 8.5e-3, 5e-5), r_corridor=(2e-3, 2e-4),
             z_tail_cells=(12, 12), mg_levels=3, density_floor=1e13)
# both packages: the structured multigrid Poisson preconditioner
PRECOND = dict(poisson_precond="mg-zline")
BENCH = dict(z_corridor=(0.0, 1.08e-2, 1e-5), r_corridor=(2e-3, 2e-5),
             density_floor=1e13)
RTOL = 1e-13


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


@pytest.fixture(scope="module")
def models():
    jm = JaxModel(JaxConfig(newton=JaxNewton(), **SMALL, **PRECOND))
    tm = StreamerModel(StreamerConfig(**SMALL, **PRECOND), device="cpu")
    jm.system.use_gather_scatter()
    tm.system.use_gather_scatter()
    return jm, tm


# -- mesh ---------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [SMALL, BENCH, dict(BENCH, mg_levels=3)],
                         ids=["small", "bench", "bench-3-levels"])
def test_coordinate_lines(cfg):
    jc = JaxConfig(newton=JaxNewton(), **cfg, **PRECOND)
    tc = StreamerConfig(**cfg, **PRECOND)
    np.testing.assert_array_equal(port_streamer.z_coords(tc),
                                  JaxModel._z_coords(jc))
    np.testing.assert_array_equal(port_streamer.r_coords(tc),
                                  JaxModel._r_coords(jc))


def test_mesh_topology_and_markers(models):
    jm, tm = models
    a, b = jm.mesh, tm.mesh
    np.testing.assert_array_equal(b.coords, a.coords)
    np.testing.assert_array_equal(b.cells, a.cells)
    np.testing.assert_array_equal(b.boundary_facets, a.boundary_facets)
    np.testing.assert_array_equal(b.boundary_cells, a.boundary_cells)
    np.testing.assert_array_equal(b.facet_markers, a.facet_markers)
    np.testing.assert_array_equal(b.facet_normals(), a.facet_normals())
    np.testing.assert_array_equal(b.cell_h(), a.cell_h())
    np.testing.assert_array_equal(b.cell_extents(), a.cell_extents())


# -- elements and quadrature ----------------------------------------------------

@pytest.mark.parametrize("degree", range(1, 7))
def test_cell_quadrature_and_tabulation(degree):
    pts, wts = cell_quadrature("triangle", degree)
    jpts, jwts = jax_cell_quadrature("triangle", degree)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(wts, jwts)
    N, dN = tabulate("triangle", 1, pts)
    jN, jdN = jax_tabulate("triangle", 1, jpts)
    np.testing.assert_array_equal(N, jN)
    np.testing.assert_array_equal(dN, jdN)


@pytest.mark.parametrize("degree", range(1, 5))
def test_facet_quadrature(degree):
    pts, wts = facet_quadrature(2, degree)
    jpts, jwts = jax_facet_quadrature(2, degree)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(wts, jwts)


def test_dirichlet_masks_and_values(models):
    jm, tm = models
    np.testing.assert_array_equal(tm.system.bcs.mask.numpy(),
                                  np.asarray(jm.system.bcs.mask))
    np.testing.assert_array_equal(tm.system.bcs.values.numpy(),
                                  np.asarray(jm.system.bcs.values(1e-9)))


# -- assembly -----------------------------------------------------------------

def test_cell_and_facet_tables(models):
    jm, tm = models
    for f in ("N", "grads", "scale"):
        _close(getattr(tm.batch, f), getattr(jm.batch, f))
    np.testing.assert_array_equal(tm.batch.dofs.numpy(),
                                  np.asarray(jm.batch.dofs))
    jf, tf = jm.system.facet_kernels[0][0], tm.system.facet_kernels[0][0]
    for f in ("N", "grads", "scale", "normal"):
        _close(getattr(tf, f), getattr(jf, f))
    np.testing.assert_array_equal(tf.dofs.numpy(), np.asarray(jf.dofs))
    # the ELL table of the electrode facets (the K1 call site)
    np.testing.assert_array_equal(tf.gather_idx.numpy(),
                                  np.asarray(jf.gather_idx)[0])


@pytest.mark.parametrize("trailing", [(), (3,), (3, 3)],
                         ids=["scalar", "n_eq", "blocks"])
def test_structured_gather_and_scatter(models, trailing):
    jm, tm = models
    assert tm.batch._structured == jm.batch._structured is not None
    rng = np.random.default_rng(1)
    u = rng.standard_normal((jm.space.n_dofs,) + trailing)
    _close(tm.batch.gather(torch.as_tensor(u)),
           jm.batch.gather(jnp.asarray(u)))
    c = rng.standard_normal((jm.mesh.n_cells, 3) + trailing)
    _close(tm.batch.scatter(torch.as_tensor(c)),
           jm.batch.scatter(jnp.asarray(c)))


@pytest.mark.parametrize("trailing", [(), (3,), (3, 3)],
                         ids=["scalar", "n_eq", "blocks"])
def test_facet_ell_gather_and_scatter(models, trailing):
    jm, tm = models
    jf, tf = jm.system.facet_kernels[0][0], tm.system.facet_kernels[0][0]
    rng = np.random.default_rng(2)
    u = rng.standard_normal((jm.space.n_dofs,) + trailing)
    _close(tf.gather(torch.as_tensor(u)), jf.gather(jnp.asarray(u)))
    c = rng.standard_normal((jf.n_facets, 3) + trailing)
    _close(tf.scatter(torch.as_tensor(c)), jf.scatter(jnp.asarray(c)))


@pytest.mark.parametrize("which", ["cell", "facet"])
def test_value_grad_mass_stiffness_integrate(models, which):
    jm, tm = models
    if which == "cell":
        jb, tb = jm.batch, tm.batch
    else:
        jb, tb = jm.system.facet_kernels[0][0], tm.system.facet_kernels[0][0]
    n, q = tb.scale.shape
    rng = np.random.default_rng(3)
    ue = rng.standard_normal((n, 3, 3))
    s = rng.standard_normal((n, q, 3))
    G = rng.standard_normal((n, q, 2, 3))
    _close(tb.value(torch.as_tensor(ue)), jb.value(jnp.asarray(ue)))
    _close(tb.grad(torch.as_tensor(ue)), jb.grad(jnp.asarray(ue)))
    _close(tb.mass(torch.as_tensor(s)), jb.mass(jnp.asarray(s)))
    _close(tb.integrate(torch.as_tensor(s)), jb.integrate(jnp.asarray(s)))
    if which == "cell":
        _close(tb.stiffness(torch.as_tensor(G)),
               jb.stiffness(jnp.asarray(G)))


def test_float32_batch_and_its_float64_view():
    """The float32 tables cast to float64 (the hi-residual evaluation) are
    the float32 values exactly, as JAX's promotion of mixed einsums sees
    them."""
    jm = JaxModel(JaxConfig(newton=JaxNewton(), dtype=jnp.float32, **SMALL,
                            **PRECOND))
    tm = StreamerModel(StreamerConfig(dtype=torch.float32, **SMALL,
                                      **PRECOND), device="cpu")
    hi = tm.batch.astype(torch.float64)
    assert hi is tm.batch.astype(torch.float64)  # cached view
    for f in ("N", "grads", "scale"):
        got = getattr(hi, f)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jm.batch, f)).astype(np.float64))
