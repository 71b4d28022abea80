"""The tensor-product Poisson machinery of the port against the JAX package:
`StencilOp` (and its `line_coeffs`), the Thomas and PCR tridiagonal solves,
`ZLineSmoother`, `StructuredTransfer`, the tensor-product
`GeometricMultigrid` with point-Chebyshev and with z-line smoothing, the
Chebyshev Poisson-row preconditioner, and the streamer's block
preconditioner with each `poisson_precond` flavour, from the same seeded
inputs in float64.

Tolerances: the stencil, the line coefficients and the transfers are the
same float64 arithmetic (1e-13 of the largest entry); the tridiagonal
solves, the smoother and the V-cycles are the same operations in another
summation order (1e-12 relative to the largest entry; measured <= 2e-15).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.fem import CellBatch as JaxBatch
from fedm_tpu.fem import FunctionSpace as JaxSpace
from fedm_tpu.fem.interpolation import StructuredTransfer as JaxTransfer
from fedm_tpu.mesh import rectangle_mesh as jax_rectangle_mesh
from fedm_tpu.solvers import linesmoother as jls
from fedm_tpu.solvers.multigrid import GeometricMultigrid as JaxMG
from fedm_tpu.solvers.stencil import StencilOp as JaxStencil
from fedm_tpu_torch.fem import CellBatch, FunctionSpace
from fedm_tpu_torch.fem.interpolation import StructuredTransfer
from fedm_tpu_torch.mesh import rectangle_mesh
from fedm_tpu_torch.solvers import linesmoother as tls
from fedm_tpu_torch.solvers.multigrid import GeometricMultigrid
from fedm_tpu_torch.solvers.stencil import StencilOp

NX, NZ = 8, 16


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


def _graded(n, length, p):
    s = np.linspace(0.0, 1.0, n + 1)
    return length * s ** p


def _meshes(nx=NX, nz=NZ):
    """(port mesh, JAX mesh) of a graded, anisotropic tensor-product grid."""
    xs, zs = _graded(nx, 1.0, 1.5), _graded(nz, 0.2, 1.3)
    out = []
    for gen in (rectangle_mesh, jax_rectangle_mesh):
        m = gen((0, 0), (1.0, 0.2), nx, nz)
        c = np.array(m.coords)
        c[:, 0] = np.interp(c[:, 0], np.unique(c[:, 0]), xs)
        c[:, 1] = np.interp(c[:, 1], np.unique(c[:, 1]), zs)
        out.append(type(m)(c, m.cells))
    return out


def _grid(nx=NX, nz=NZ):
    I, J = np.meshgrid(np.arange(nx + 1), np.arange(nz + 1), indexing="ij")
    return J * (nx + 1) + I


@pytest.fixture(scope="module")
def laplacians():
    """The masked axisymmetric Laplacian in each package: (port A, JAX A,
    n_dofs)."""
    tmesh, jmesh = _meshes()
    tspace, jspace = FunctionSpace(tmesh), JaxSpace(jmesh, 1)
    tb = CellBatch(tspace, quad_degree=2, axisymmetric=True, device="cpu")
    jb = JaxBatch(jspace, quad_degree=2, axisymmetric=True)
    c = tspace.dof_coords
    mask = np.isclose(c[:, 1], 0.0) | np.isclose(c[:, 1], 0.2)
    tm, jm = torch.as_tensor(mask), jnp.asarray(mask)

    def tA(x):
        x_in = torch.where(tm, 0.0, x)
        return torch.where(tm, x, tb.scatter(tb.stiffness(tb.grad(
            tb.gather(x_in)))))

    def jA(x):
        x_in = jnp.where(jm, 0.0, x)
        return jnp.where(jm, x, jb.scatter(jb.stiffness(jb.grad(
            jb.gather(x_in)))))

    return tA, jA, tspace.n_dofs


def test_stencil_and_line_coeffs(laplacians):
    tA, jA, n = laplacians
    st = StencilOp(tA, _grid(), n, device="cpu")
    jst = JaxStencil(jA, _grid(), n)
    _close(st._S, jst._S, 1e-13)
    for got, ref in zip(st.line_coeffs(), jst.line_coeffs()):
        _close(got, ref, 1e-13)
    x = np.random.default_rng(0).standard_normal(n)
    _close(st(torch.as_tensor(x)), jst(jnp.asarray(x)), 1e-13)
    _close(st(torch.as_tensor(x)), tA(torch.as_tensor(x)), 1e-12)


def test_stencil_refuses_an_operator_beyond_nine_points():
    n = (NX + 1) * (NZ + 1)

    def wide(x):  # couples each dof to the one two columns on
        return x + torch.roll(x, 2)

    with pytest.raises(ValueError, match="9-point"):
        StencilOp(wide, _grid(), n, device="cpu")


@pytest.mark.parametrize("n", [1, 2, 17, 64, 101])
def test_tridiagonal_solves(n):
    rng = np.random.default_rng(n)
    a, c = rng.standard_normal((2, 4, n)) * 0.4
    b = 2.5 + np.abs(rng.standard_normal((4, n)))
    a[:, 0] = c[:, -1] = 0.0
    d = rng.standard_normal((4, n))
    tt = [torch.as_tensor(v) for v in (a, b, c, d)]
    jj = [jnp.asarray(v) for v in (a, b, c, d)]
    ref = jls.tridiag_solve_batched(*jj)
    _close(tls.tridiag_solve_batched(*tt), ref, 1e-12)
    _close(tls.tridiag_solve_pcr(*tt), ref, 1e-12)


@pytest.mark.parametrize("method,n_iter", [("pcr", 1), ("pcr", 2),
                                           ("thomas", 2)])
def test_zline_smoother(laplacians, method, n_iter):
    tA, jA, n = laplacians
    sm = tls.ZLineSmoother(tA, _grid(), n, n_iter=n_iter, method=method,
                           device="cpu")
    jsm = jls.ZLineSmoother(jA, _grid(), n, n_iter=n_iter, method=method)
    for got, ref in ((sm._a, jsm._a), (sm._b, jsm._b), (sm._c, jsm._c)):
        _close(got, ref, 1e-13)
    r = np.random.default_rng(1).standard_normal(n)
    _close(sm.solve(torch.as_tensor(r)), jsm.solve(jnp.asarray(r)), 1e-12)


def test_structured_transfer():
    fine, _ = _meshes()
    coarse, _ = _meshes(NX // 2, NZ // 2)
    xf, zf = np.unique(fine.coords[:, 0]), np.unique(fine.coords[:, 1])
    xc, zc = xf[::2], zf[::2]
    tr = StructuredTransfer(xc, zc, xf, zf, device="cpu")
    jtr = JaxTransfer(xc, zc, xf, zf)
    rng = np.random.default_rng(2)
    ec = rng.standard_normal(len(xc) * len(zc))
    rf = rng.standard_normal(len(xf) * len(zf))
    _close(tr.prolong(torch.as_tensor(ec)), jtr.prolong(jnp.asarray(ec)),
           1e-13)
    _close(tr.restrict(torch.as_tensor(rf)), jtr.restrict(jnp.asarray(rf)),
           1e-13)
    with pytest.raises(ValueError, match="nested"):
        StructuredTransfer(xc, zc, xf[:-1], zf, device="cpu")


@pytest.mark.parametrize("lines", [False, True], ids=["chebyshev", "zline"])
def test_tensor_product_multigrid(lines):
    spaces, jspaces, masks = [], [], []
    for k in range(3):
        tmesh, jmesh = _meshes(NX >> k, NZ >> k)
        spaces.append(FunctionSpace(tmesh))
        jspaces.append(JaxSpace(jmesh, 1))
        c = spaces[-1].dof_coords
        masks.append(np.isclose(c[:, 1], 0.0) | np.isclose(c[:, 1], 0.2))
    grids = [_grid(NX >> k, NZ >> k) for k in range(3)] if lines else None
    mg = GeometricMultigrid(spaces, masks, axisymmetric=True,
                            line_grids=grids, device="cpu")
    jmg = JaxMG(jspaces, masks, axisymmetric=True, line_grids=grids)
    assert all(isinstance(op, StencilOp) for op in mg.ops[:-1])
    assert all(isinstance(t, StructuredTransfer) for t in mg.transfers)
    # a power iteration per point-smoothed level only
    assert len(mg.lmax) == (0 if lines else 2)
    r = np.random.default_rng(3).standard_normal(spaces[0].n_dofs)
    _close(mg.precond(torch.as_tensor(r)), jmg.precond(jnp.asarray(r)),
           1e-12)


def test_chebyshev_elliptic_preconditioner():
    """`enable_elliptic_precond`'s default: a Chebyshev polynomial in the
    Jacobi-scaled masked Laplacian of the Poisson row, on the graded
    streamer (float64; the power iteration's seeded start vector is the
    JAX package's)."""
    from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
    from fedm_tpu.models.streamer import StreamerModel as JaxModel
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel

    cfg = dict(nx=16, ny=24, mg_levels=1)
    jm = JaxModel(JaxConfig(**cfg))
    tm = StreamerModel(StreamerConfig(**cfg), device="cpu")
    assert jm.system._ell is None and tm.system._ell is None
    jm.system.enable_elliptic_precond(2)
    tm.system.enable_elliptic_precond(2)
    r = np.random.default_rng(6).standard_normal(tm.system.n_dofs)
    _close(tm.system._ell[1](torch.as_tensor(r)),
           jm.system._ell[1](jnp.asarray(r)), 1e-12)


@pytest.mark.parametrize("flavour", ["mg", "zline", "mg-zline"])
def test_poisson_row_flavours_in_the_preconditioner(flavour):
    """M r of the streamer's block preconditioner with each Poisson-row
    flavour, at the initial state of the graded 16 x 24 streamer (float64;
    measured <= 1.4e-14 of each column's largest entry, the ion row's
    3 x 3 block inverse)."""
    from fedm_tpu.model.system import StepParams as JaxParams
    from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
    from fedm_tpu.models.streamer import StreamerModel as JaxModel
    from fedm_tpu_torch.convert import state_from_arrays
    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel

    cfg = dict(nx=16, ny=24, poisson_precond=flavour)
    jm = JaxModel(JaxConfig(**cfg))
    tm = StreamerModel(StreamerConfig(**cfg), device="cpu")
    js = jm.initial_state()
    ts = state_from_arrays(js, device="cpu")
    p = (js.dt, js.dt, 1e30)
    args = jm.system._cast_inputs(js.u, js.u, js.u_old1, {}, JaxParams(
        *(jnp.asarray(x) for x in p)))[:5]
    M = jm.system.block_precond_builder(*args[1:])(args[0])
    ops = tm.system.operators(ts.u, ts.u_old1, StepParams(*p))
    Mt = tm.system.block_precond_builder(ops)(torch.zeros_like(ts.u))
    r = np.random.default_rng(7).standard_normal((tm.system.n_dofs, 3))
    got, ref = Mt(torch.as_tensor(r)).numpy(), np.asarray(M(jnp.asarray(r)))
    for k in range(3):
        _close(got[:, k], ref[:, k], 1e-12)
