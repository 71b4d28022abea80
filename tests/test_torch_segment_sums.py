"""The multigrid's segment sums through K1's dense form (its plain version
on the CPU), and the batched layer under the sweep.

- A level's assembly sum (`_Level.segment_sum`) and the P1 restriction
  (`restrict` over `restrict_table`) against the JAX package's
  `segment_sum` and `restrict`, float64, to 1e-14 relative; and against
  the in-place `index_add_` they replace, which sums in the same element
  order.
- Every multigrid operator with trailing right-hand sides: one V-cycle of
  [n, B] equals B V-cycles of [n] to 1e-13 relative (the glow's assembled
  levels and P1 transfers; the streamer's stencil levels and separable
  transfers), and so do the Chebyshev elliptic solve and the masked
  stiffness operator.
- The batched Krylov solvers against the single ones, member by member,
  on B systems of different conditioning: the same iteration counts and
  the iterates to 1e-12; the batched dots and norms against `_dot` and
  `_norm`; the batched Newton through the GMRES fallback and the
  true-residual rescue against the single system's, member by member.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.fem import interpolation as jinterp
from fedm_tpu.fem.space import FunctionSpace as JaxSpace
from fedm_tpu.mesh import rectangle_mesh as jax_rectangle_mesh
from fedm_tpu_torch.fem import FunctionSpace
from fedm_tpu_torch.fem import interpolation as tinterp
from fedm_tpu_torch.fem.assembly import CellBatch
from fedm_tpu_torch.mesh import rectangle_mesh
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers import linear
from fedm_tpu_torch.solvers.multigrid import GeometricMultigrid, _Level
from fedm_tpu_torch.solvers.stencil import StencilOp

N = 12
BOX = ((0, 0), (0.01, 0.01))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_level_segment_sum(trailing):
    import jax

    mesh = rectangle_mesh(*BOX, N, N, "crossed")
    space = FunctionSpace(mesh)
    batch = CellBatch(space, quad_degree=2, device="cpu")
    mask = torch.zeros(space.n_dofs, dtype=torch.bool)
    lev = _Level(space, batch, mask)
    assert lev._ell.dtype == torch.int32
    c = np.random.default_rng(1).standard_normal(
        (mesh.n_cells, 3) + trailing)
    got = lev.segment_sum(torch.as_tensor(c)).numpy()
    ref = jax.ops.segment_sum(jnp.asarray(c.reshape((-1,) + trailing)),
                              jnp.asarray(batch.dofs_np.reshape(-1)),
                              num_segments=space.n_dofs)
    assert _rel(got, ref) <= 1e-14
    old = torch.zeros((space.n_dofs,) + trailing, dtype=torch.float64)
    old.index_add_(0, batch.dofs.reshape(-1),
                   torch.as_tensor(c.reshape((-1,) + trailing)))
    assert _rel(got, old.numpy()) <= 1e-15


def test_p1_restriction_through_its_table():
    fine = rectangle_mesh(*BOX, N, N, "crossed")
    coarse = rectangle_mesh(*BOX, N // 2, N // 2, "crossed")
    jidx, jw = jinterp.p1_transfer(
        JaxSpace(jax_rectangle_mesh(*BOX, N // 2, N // 2, "crossed"), 1),
        JaxSpace(jax_rectangle_mesh(*BOX, N, N, "crossed"), 1))
    idx, w = tinterp.p1_transfer(FunctionSpace(coarse), FunctionSpace(fine),
                                 device="cpu")
    table = tinterp.restrict_table(idx, coarse.n_verts)
    assert table.shape[0] == coarse.n_verts and table.dtype == torch.int32
    rf = np.random.default_rng(2).standard_normal((fine.n_verts, 4))
    got = tinterp.restrict(idx, w, torch.as_tensor(rf), coarse.n_verts,
                           table).numpy()
    for j in range(4):
        ref = jinterp.restrict(jidx, jw, jnp.asarray(rf[:, j]),
                               coarse.n_verts)
        assert _rel(got[:, j], ref) <= 1e-14
    # prolongation with trailing columns, column by column
    uc = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (coarse.n_verts, 4)))
    pc = tinterp.prolong(idx, w, uc)
    for j in range(4):
        assert torch.equal(pc[:, j], tinterp.prolong(idx, w, uc[:, j]))


def _glow_mg():
    spaces = [FunctionSpace(rectangle_mesh(*BOX, n, n, "crossed"))
              for n in (N, N // 2)]
    masks = [np.isclose(sp.dof_coords[:, 1], 0.0)
             | np.isclose(sp.dof_coords[:, 1], 0.01) for sp in spaces]
    return GeometricMultigrid(spaces, masks, axisymmetric=True,
                              device="cpu")


def _streamer_mg():
    m = StreamerModel(StreamerConfig(nx=16, ny=32), device="cpu")
    return m, m.system._ell[1]


@pytest.mark.parametrize("kind", ["glow", "streamer"])
def test_vcycle_with_trailing_right_hand_sides(kind):
    if kind == "glow":
        mg = _glow_mg()
        assert not any(isinstance(op, StencilOp) for op in mg.ops)
        solve, n = mg.precond, mg.levels[0].n
    else:
        m, solve = _streamer_mg()
        mg = solve.__self__
        assert isinstance(mg.ops[0], StencilOp) and len(mg.levels) == 3
        assert isinstance(mg.transfers[0], tinterp.StructuredTransfer)
        n = m.space.n_dofs
    R = torch.as_tensor(np.random.default_rng(4).standard_normal((n, 5)))
    Z = solve(R)
    assert Z.shape == R.shape
    for j in range(5):
        assert _rel(Z[:, j], solve(R[:, j].contiguous())) <= 1e-13


def test_chebyshev_solve_and_stiffness_with_trailing_columns():
    m = StreamerModel(StreamerConfig(nx=8, ny=12, mg_levels=1),
                      device="cpu")
    m.system.enable_elliptic_precond(2, degree=6, power_iters=10)
    A = m.system.masked_stiffness_op(2)
    solve = m.system._ell[1]
    X = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (m.space.n_dofs, 3)))
    AX, ZX = A(X), solve(X)
    for j in range(3):
        assert _rel(AX[:, j], A(X[:, j].contiguous())) <= 1e-13
        assert _rel(ZX[:, j], solve(X[:, j].contiguous())) <= 1e-13


# -- the batched Krylov layer ----------------------------------------------


def _systems(B=4, n=60, seed=6):
    """B nonsymmetric, diagonally dominant tridiagonal systems of rising
    difficulty, and their right-hand sides [B, n, 2]."""
    rng = np.random.default_rng(seed)
    mats = []
    for b in range(B):
        d = 2.0 + 0.3 * b + rng.random(n)
        off = 1.0 + 0.25 * b
        A = (np.diag(d) - off * np.diag(rng.random(n - 1), 1)
             - 0.7 * off * np.diag(rng.random(n - 1), -1))
        mats.append(np.kron(A, np.eye(2)))
    mats = torch.as_tensor(np.stack(mats))
    rhs = torch.as_tensor(rng.standard_normal((B, n, 2)))

    def matvec(x):
        return torch.einsum("bij,bj->bi", mats,
                            x.reshape(B, -1)).reshape(x.shape)

    return matvec, mats, rhs


def test_dot_and_norm_per_member():
    a = torch.as_tensor(np.random.default_rng(7).standard_normal((3, 5, 2))
                        * np.array([1e-200, 1.0, 1e200])[:, None, None])
    b = a.flip(0) * 3.0
    for i in range(3):
        assert torch.isclose(linear.dot_b(a, b)[i], linear._dot(a[i], b[i]),
                             rtol=1e-15, atol=0)
        assert torch.isclose(linear.norm_b(a)[i], linear._norm(a[i]),
                             rtol=1e-15, atol=0)


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_batched_krylov_is_the_single_solver_per_member(solver):
    matvec, mats, rhs = _systems()
    B = rhs.shape[0]
    kw = dict(tol=1e-10, maxiter=200)
    if solver == "gmres":
        kw["restart"] = 7   # several cycles each
    batched = getattr(linear, f"{solver}_batched")
    single = getattr(linear, solver)
    active = np.array([True, True, False, True])
    x, rel, its = batched(matvec, rhs, active=active, **kw)
    assert torch.equal(x[2], torch.zeros_like(x[2]))
    counts = []
    for b in np.flatnonzero(active):
        xs, rs, ks = single(lambda v, b=b: (mats[b] @ v.reshape(-1))
                            .reshape(v.shape), rhs[b], **kw)
        counts.append(ks)
        assert its[b] == ks
        assert _rel(x[b], xs) <= 1e-12
        assert abs(float(rel[b]) - float(rs)) <= 1e-12
        assert float(rel[b]) <= 1e-10
    # the members stop on their own counts
    assert len(set(counts)) > 1


def test_batched_newton_with_fallback_and_rescue_is_the_single_one():
    """`newton_krylov_batched` through the GMRES fallback and the
    true-residual rescue (a BiCGStab capped at 5 iterations, so every
    member falls back, and a rescue threshold its directions miss): each
    member of a 3-member batch takes the single system's `newton_krylov`
    path, with the same Newton iterations and its state to 1e-10 of each
    column's max."""
    from fedm_tpu_torch.model.system import BatchedSystem, StepParams
    from fedm_tpu_torch.solvers.newton import NewtonConfig

    nc = NewtonConfig(rtol=1e-4, linear_tol=1e-6, linear_maxiter=5,
                      gmres_restart=10, true_res_rescue=1e-3)
    models = [StreamerModel(StreamerConfig(nx=8, ny=10, seed_amplitude=a,
                                           newton=nc), device="cpu")
              for a in (2e18, 5e18, 1e19)]
    states = [m.initial_state() for m in models]
    u = torch.stack([s.u for s in states])
    p = StepParams(np.full(3, 5e-12), np.full(3, 5e-12), np.full(3, 1e30))
    bs = BatchedSystem(models[0].system, 3)
    u_b, info_b = bs.step(u, u, u, {}, p)
    for b, (m, s) in enumerate(zip(models, states)):
        u_s, info_s = models[0].system.step(s.u, s.u, s.u, {},
                                            StepParams(5e-12, 5e-12, 1e30))
        assert int(info_b.iters[b]) == int(info_s.iters) > 0
        assert bool(info_b.converged[b]) == bool(info_s.converged)
        scale = u_s.abs().amax(dim=0)
        assert float(((u_b[b] - u_s).abs().amax(dim=0) / scale).max()) \
            <= 1e-10
