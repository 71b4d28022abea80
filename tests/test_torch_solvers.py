"""Linear-algebra building blocks of the port against the JAX package:
range-scaled float64 reductions, the node-block inverse and its guard, PCR
line solves, the structured Poisson V-cycle, BiCGStab and GMRES(m), and the
Newton convergence verdict. Everything is float64 on both sides; the
tolerances allow for summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.solvers import linear as jax_linear
from fedm_tpu.solvers.linesmoother import tridiag_solve_pcr as jax_pcr
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu.solvers.newton import newton_converged as jax_converged
from fedm_tpu.solvers.precond import block_apply as jax_block_apply
from fedm_tpu.solvers.precond import invert_blocks as jax_invert_blocks
from fedm_tpu.solvers.structured_mg import StructuredPoissonMG as JaxMG
from fedm_tpu_torch.models.streamer import StreamerConfig, r_coords, z_coords
from fedm_tpu_torch.solvers import linear
from fedm_tpu_torch.solvers.linesmoother import tridiag_solve_pcr
from fedm_tpu_torch.solvers.newton import NewtonConfig, newton_converged
from fedm_tpu_torch.solvers.precond import block_apply, invert_blocks
from fedm_tpu_torch.solvers.structured_mg import StructuredPoissonMG


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_range_scaled_dot_and_norm(scale, dtype):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((500, 3)) * scale).astype(dtype)
    b = (rng.standard_normal((500, 3)) * np.geomspace(1e-3, 1e3, 3)).astype(
        dtype)
    for fn in ("_dot", "_norm"):
        args = (a, b) if fn == "_dot" else (a,)
        got = getattr(linear, fn)(*map(torch.as_tensor, args))
        ref = getattr(jax_linear, fn)(*map(jnp.asarray, args))
        assert got.dtype == torch.float64
        assert _rel(got, ref) < 1e-14


def test_norm_survives_where_the_plain_sum_of_squares_overflows():
    x = torch.full((10,), 1e200, dtype=torch.float64)
    assert float(linear._norm(x)) == pytest.approx(1e200 * np.sqrt(10))


def test_invert_blocks_and_apply():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((64, 3, 3)) + 4 * np.eye(3)
    A[:, 1] *= 1e25           # rows of wildly different physical scale
    A[3, :, 2] = 0.0          # a structurally singular block (zero column)
    A[5] = np.diag([2.0, 0.0, np.inf])  # dead and non-finite diagonal
    got = invert_blocks(torch.as_tensor(A))
    ref = jax_invert_blocks(jnp.asarray(A))
    for n in range(len(A)):
        assert _rel(got[n], ref[n]) < 1e-12, n
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    r = rng.standard_normal((64, 3))
    assert _rel(block_apply(got, torch.as_tensor(r)),
                jax_block_apply(ref, jnp.asarray(r))) < 1e-12


@pytest.mark.parametrize("n", [1, 2, 37, 64])
def test_tridiag_solve_pcr(n):
    rng = np.random.default_rng(2)
    a, c, d = (rng.standard_normal((5, n)) for _ in range(3))
    b = 2.5 + np.abs(a) + np.abs(c)
    got = tridiag_solve_pcr(*map(torch.as_tensor, (a, b, c, d)))
    ref = jax_pcr(*map(jnp.asarray, (a, b, c, d)))
    assert _rel(got, ref) < 1e-13
    # and it solves the system
    x = got.numpy()
    Ax = b * x
    Ax[:, 1:] += a[:, 1:] * x[:, :-1]
    Ax[:, :-1] += c[:, :-1] * x[:, 1:]
    np.testing.assert_allclose(Ax, d, atol=1e-12)


@pytest.mark.parametrize("levels", [2, 3])
def test_structured_poisson_vcycle(levels):
    cfg = StreamerConfig(z_corridor=(7e-3, 8.5e-3, 5e-5),
                         r_corridor=(2e-3, 2e-4), z_tail_cells=(12, 12),
                         mg_levels=3)
    xs, zs = r_coords(cfg), z_coords(cfg)
    mask = np.zeros((len(xs), len(zs)), bool)
    mask[:, 0] = mask[:, -1] = True
    mg = StructuredPoissonMG(xs, zs, mask, levels, device="cpu")
    ref = JaxMG(xs, zs, mask, levels)
    assert mg.n_levels == ref.n_levels == levels
    for k in range(levels):
        np.testing.assert_array_equal(mg.S[k].numpy(),
                                      np.asarray(ref.geom()["S"][k]))
    assert _rel(mg.cinv, ref.geom()["cinv"]) < 1e-15
    r = np.random.default_rng(3).standard_normal(len(xs) * len(zs))
    assert _rel(mg.precond(torch.as_tensor(r)),
                ref.precond(jnp.asarray(r))) < 1e-12


def _system(n=60, seed=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) + 3 * np.eye(n)
    A[np.arange(n - 1), np.arange(1, n)] += 1.5  # nonsymmetric
    b = rng.standard_normal((n // 3, 3))
    dinv = 1.0 / np.diag(A)
    return A, b, dinv


def _ops(A, dinv, lib):
    if lib == "torch":
        At, dt_ = torch.as_tensor(A), torch.as_tensor(dinv)
        return (lambda x: (At @ x.reshape(-1)).reshape(x.shape),
                lambda r: (dt_ * r.reshape(-1)).reshape(r.shape))
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)
    return (lambda x: (Aj @ x.reshape(-1)).reshape(x.shape),
            lambda r: (dj * r.reshape(-1)).reshape(r.shape))


@pytest.mark.parametrize("solver,kw", [
    ("bicgstab", dict(tol=1e-10, maxiter=100)),
    ("bicgstab", dict(tol=1e-10, maxiter=4)),
    ("bicgstab", dict(tol=1e-10, maxiter=100, stall_window=2,
                      stall_factor=0.2)),
    ("gmres", dict(tol=1e-10, maxiter=60, restart=7)),
    ("gmres", dict(tol=1e-10, maxiter=60, restart=7, stall_window=3,
                   stall_factor=0.5)),
], ids=["bicgstab", "bicgstab-capped", "bicgstab-stall", "gmres",
        "gmres-stall"])
def test_krylov_solvers_follow_the_reference(solver, kw):
    A, b, dinv = _system()
    mt, pt = _ops(A, dinv, "torch")
    mj, pj = _ops(A, dinv, "jax")
    x, relres, k = getattr(linear, solver)(mt, torch.as_tensor(b),
                                           precond=pt, **kw)
    xr, relres_r, kr = jax.jit(lambda bb: getattr(jax_linear, solver)(
        mj, bb, precond=pj, **kw))(jnp.asarray(b))
    assert k == int(kr)
    assert float(relres) == pytest.approx(float(relres_r), rel=1e-6)
    assert _rel(x, xr) < 1e-9
    if kw["maxiter"] > 10 and "stall_window" not in kw:
        assert float(relres) <= kw["tol"]


@pytest.mark.parametrize("fnorm,stalls,capped", [
    (0.5, 0, False), (2.0, 0, False), (20.0, 2, False), (20.0, 1, False),
    (20.0, 0, True), (40.0, 2, False), (float("nan"), 2, False),
    (float("inf"), 0, True)])
def test_newton_verdict(fnorm, stalls, capped):
    cfg = dict(rtol=1e-3, accept_reduction=3e-2, max_stalls=2)
    got = newton_converged(fnorm, 1000.0, 1.0, stalls, NewtonConfig(**cfg),
                           capped)
    ref = jax_converged(fnorm, 1000.0, 1.0, stalls, False, JaxNewton(**cfg),
                        capped)
    assert got == bool(ref)


@pytest.mark.parametrize("solver,taken", [
    ("bicgstab", True), ("gmres", True), ("cg", False), ("minres", False)])
def test_newton_takes_bicgstab_or_gmres(solver, taken):
    """The Newton inner solve is BiCGStab (with its GMRES fallback) or
    GMRES(m): the coupled Jacobian is not symmetric, so CG is refused."""
    if taken:
        assert NewtonConfig(linear_solver=solver).linear_solver == solver
    else:
        with pytest.raises(ValueError, match="linear_solver"):
            NewtonConfig(linear_solver=solver)
