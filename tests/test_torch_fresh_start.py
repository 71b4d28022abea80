"""The port's fresh start against the JAX package: the mesh generators
(graded, wall-clustered tail, corridor), preconditioned CG and the initial
Poisson solve, the streamer's initial state, and the stabilised residual and
Jacobian action.

Tolerances: coordinate lines come from the same numpy arithmetic and agree
to 1e-15 relative. CG and the Poisson solve in float64 follow the same
iterations (the same iteration count; solution to 1e-12 of its magnitude).
The initial state in float64: the log-densities exactly (the same numpy
expression), the potential to 1e-9 of max|phi| (measured 4e-16 and 8e-16
on the two meshes: summation order in the CG reductions). The stabilised
float64 residual and J v agree to 1e-12 of each equation's magnitude, as
the unstabilised ones do (tests/test_torch_system.py). At an exact tie of
`peclet`'s maximum both packages split the tangent 0.5/0.5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JaxParams
from fedm_tpu.models import streamer as jax_streamer
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.ops.stabilization import upwind_diffusion as jax_upwind
from fedm_tpu.solvers import elliptic as jax_elliptic
from fedm_tpu.solvers import linear as jax_linear
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models import streamer as port_streamer
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.ops.stabilization import upwind_diffusion
from fedm_tpu_torch.solvers import elliptic, linear

SMALL = dict(z_corridor=(7e-3, 8.5e-3, 5e-5), r_corridor=(2e-3, 2e-4),
             z_tail_cells=(12, 12), mg_levels=3, density_floor=1e13)
GRADED = dict(nx=16, ny=24)
# both packages: the structured multigrid Poisson preconditioner
PRECOND = dict(poisson_precond="mg-zline")
PARAMS = (1e-12, 1e-12, 2e-12)  # t, dt, dt_old


def _rel_max(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _assert_close_per_eq(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    for k in range(ref.shape[1]):
        assert np.abs(got[:, k] - ref[:, k]).max() <= \
            rtol * np.abs(ref[:, k]).max(), k


# -- mesh generators ------------------------------------------------------------

@pytest.mark.parametrize("n,length,grade,focus", [
    (16, 0.0125, 2.5, 0.0), (24, 0.0125, 2.5, 0.8), (7, 1.0, 0.0, 0.3),
    (33, 2e-3, 4.0, 1.0)])
def test_graded_coords(n, length, grade, focus):
    np.testing.assert_allclose(
        port_streamer._graded_coords(n, length, grade, focus),
        jax_streamer._graded_coords(n, length, grade, focus),
        rtol=1e-15, atol=0)


@pytest.mark.parametrize("span,dz,dz_wall,n", [
    (9.1e-3, 1e-5, 2.5e-7, 10), (1e-4, 1e-5, 1e-6, 11),
    (5e-3, 5e-5, 5e-5, 12)])
def test_wall_tail(span, dz, dz_wall, n):
    got = port_streamer._wall_tail(span, dz, dz_wall, n)
    np.testing.assert_allclose(
        got, JaxModel._wall_tail(span, dz, dz_wall, n), rtol=1e-15, atol=0)
    assert got.sum() == pytest.approx(span, rel=1e-14)


@pytest.mark.parametrize("cfg", [
    GRADED, dict(GRADED, grade=0.0, seed_z=5e-3), SMALL,
    dict(SMALL, z_wall_dz=1e-6), dict(SMALL, z_tail_cells=None),
    dict(GRADED, r_corridor=(2e-3, 2e-4))],
    ids=["graded", "uniform", "corridor", "wall-tail", "corridor-free-tails",
         "graded-z-corridor-r"])
def test_coordinate_lines_and_mesh(cfg):
    jc = JaxConfig(**cfg, **PRECOND)
    tc = StreamerConfig(**cfg, **PRECOND)
    np.testing.assert_allclose(port_streamer.z_coords(tc),
                               JaxModel._z_coords(jc, jc.ny), rtol=1e-15,
                               atol=0)
    jm = JaxModel._make_mesh(jc, jc.nx, jc.ny)
    tm = port_streamer.make_mesh(tc)
    np.testing.assert_allclose(tm.coords, jm.coords, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(tm.cells, jm.cells)


def test_config_defaults_match():
    jc, tc = JaxConfig(), StreamerConfig()
    for name in ("U_w", "p0", "Tgas", "box_width", "box_height", "nx", "ny",
                 "grade", "seed_amplitude", "seed_width", "seed_z",
                 "background", "dt_init", "dt_min", "dt_max", "ttol",
                 "T_final", "quad_degree", "Em_floor", "stab_diffusion",
                 "stab_mode", "stab_coeff", "mg_levels", "z_corridor",
                 "z_tail_cells", "z_wall_dz", "r_corridor", "density_floor",
                 "N0", "poisson_precond", "zline_iters", "transport_zline",
                 "row_scaled"):
        assert getattr(tc, name) == getattr(jc, name), name
    for jdt, tdt in ((jnp.float32, torch.float32), (None, None)):
        jn = JaxConfig(dtype=jdt).newton
        tn = StreamerConfig(dtype=tdt).newton
        for name in ("rtol", "max_iter", "linear_tol", "linear_maxiter",
                     "accept_reduction", "hi_residual", "linear_solver",
                     "host_loop", "stol"):
            assert getattr(tn, name) == getattr(jn, name), (tdt, name)
    with pytest.raises(ValueError):
        StreamerConfig(stab_mode="supg")


# -- CG and the Poisson solve ---------------------------------------------------

def _spd(n=60, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.diag(rng.uniform(0.5, 2.0, n))
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("kw", [dict(tol=1e-12, maxiter=200),
                                dict(tol=1e-12, maxiter=5),
                                dict(tol=1e-3, maxiter=200, atol=1e-2)],
                         ids=["converged", "capped", "atol"])
def test_cg_follows_the_reference(kw):
    A, b = _spd()
    dinv = 1.0 / np.diag(A)
    At = torch.as_tensor(A)
    x, relres, k = linear.cg(lambda v: At @ v, torch.as_tensor(b),
                             precond=lambda r: r * torch.as_tensor(dinv),
                             **kw)
    Aj = jnp.asarray(A)
    xr, relres_r, kr = jax_linear.cg(lambda v: Aj @ v, jnp.asarray(b),
                                     precond=lambda r: r * jnp.asarray(dinv),
                                     **kw)
    assert k == int(kr)
    assert float(relres) == pytest.approx(float(relres_r), rel=1e-9)
    assert _rel_max(x.numpy(), xr) < 1e-12


@pytest.fixture(scope="module")
def graded64():
    jm = JaxModel(JaxConfig(**GRADED, **PRECOND))
    tm = StreamerModel(StreamerConfig(**GRADED, **PRECOND), device="cpu")
    return jm, tm


def test_stiffness_diagonal(graded64):
    jm, tm = graded64
    _assert_close_per_eq(
        elliptic.stiffness_diagonal(tm.batch)[:, None],
        np.asarray(jax_elliptic.stiffness_diagonal(jm.batch))[:, None],
        1e-14)


@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_solve_poisson(graded64, precond):
    jm, tm = graded64
    rng = np.random.default_rng(3)
    f_q = rng.standard_normal((tm.mesh.n_cells, 3)) * 1e6
    z = tm.space.dof_coords[:, 1]
    mask = np.isclose(z, 0.0) | np.isclose(z, tm.cfg.box_height)
    g = np.where(np.isclose(z, tm.cfg.box_height), 100.0, 0.0)
    u, relres, k = elliptic.solve_poisson(
        tm.batch, torch.as_tensor(f_q), torch.as_tensor(mask),
        torch.as_tensor(g), tol=1e-12, maxiter=2000,
        precond=None if precond == "jacobi" else tm.system._ell[1])
    ur, relres_r, kr = jax_elliptic.solve_poisson(
        jm.batch, jnp.asarray(f_q), jnp.asarray(mask), jnp.asarray(g),
        tol=1e-12, maxiter=2000,
        precond=None if precond == "jacobi" else jm.system._ell[1])
    assert k == int(kr) and float(relres) < 1e-12
    assert _rel_max(u.numpy(), ur) < 1e-12


# -- the initial state ----------------------------------------------------------

@pytest.mark.parametrize("cfg", [GRADED, SMALL], ids=["graded", "corridor"])
def test_initial_state_float64(cfg):
    js = JaxModel(JaxConfig(**cfg, **PRECOND)).initial_state()
    tm = StreamerModel(StreamerConfig(**cfg, **PRECOND), device="cpu")
    ts = tm.initial_state()
    ju = np.asarray(js.u)
    for got in (ts.u, ts.u_old, ts.u_old1):
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got[:, :2].numpy(), ju[:, :2])
        assert _rel_max(got[:, 2].numpy(), ju[:, 2]) <= 1e-9
    assert (ts.t, ts.dt, ts.dt_old, ts.n_accepted) == (js.t, js.dt,
                                                       js.dt_old, 0)
    assert tm.initial_poisson[0] < 1e-12


def test_initial_state_raises_when_poisson_misses(monkeypatch):
    tm = StreamerModel(StreamerConfig(**GRADED, **PRECOND), device="cpu")
    real = port_streamer.solve_poisson
    monkeypatch.setattr(port_streamer, "solve_poisson",
                        lambda *a, **kw: real(*a, **{**kw, "maxiter": 2}))
    with pytest.raises(RuntimeError, match="did not converge"):
        tm.initial_state()


# -- stabilisation --------------------------------------------------------------

def test_peclet_tie_splits_the_tangent():
    rng = np.random.default_rng(4)
    # dyadic values: 0.5 * speed * h == D exactly, a tie everywhere
    D = rng.integers(1, 100, (5, 3)) / 64.0
    h = 2.0 ** -rng.integers(10, 17, (5, 3)).astype(float)
    speed = 2.0 * D / h
    assert np.array_equal(0.5 * speed * h, D)
    tD, ts = rng.standard_normal((2, 5, 3))
    _, ref = jax.jvp(lambda a, b: jax_upwind(a, b, jnp.asarray(h), "peclet"),
                     (jnp.asarray(D), jnp.asarray(speed)),
                     (jnp.asarray(tD), jnp.asarray(ts)))
    with fwAD.dual_level():
        out = upwind_diffusion(
            fwAD.make_dual(torch.as_tensor(D), torch.as_tensor(tD)),
            fwAD.make_dual(torch.as_tensor(speed), torch.as_tensor(ts)),
            torch.as_tensor(h), "peclet")
        got = fwAD.unpack_dual(out).tangent.numpy()
    expect = 0.5 * tD + 0.5 * (0.5 * ts * h)
    np.testing.assert_allclose(got, expect, rtol=1e-15)
    np.testing.assert_allclose(np.asarray(ref), expect, rtol=1e-15)


def _states(space):
    """A seeded streamer-like history (u_old1, u_old) and iterate u."""
    c = space.dof_coords
    rng = np.random.default_rng(0)
    u_old1 = np.stack([
        np.log(1e13 + 5e18 * np.exp(-(c[:, 0] ** 2 + (c[:, 1] - 1e-2) ** 2)
                                    / 0.4e-3 ** 2)),
        np.log(1e13 + 1e18 * np.exp(-(c[:, 0] ** 2 + (c[:, 1] - 9e-3) ** 2)
                                    / 0.3e-3 ** 2)),
        18750.0 * c[:, 1] / 0.0125], axis=-1)
    noise = np.array([1e-3, 1e-3, 10.0])
    u_old = u_old1 + noise * rng.standard_normal(u_old1.shape)
    u = u_old + noise * rng.standard_normal(u_old1.shape)
    return u, u_old, u_old1


@pytest.mark.parametrize("stab", [dict(stab_mode="peclet"),
                                  dict(stab_mode="linear", stab_coeff=0.7),
                                  dict(stab_diffusion=1.0)],
                         ids=["peclet", "linear", "stab_diffusion"])
def test_stabilised_residual_and_jv(stab):
    jm = JaxModel(JaxConfig(**SMALL, **stab, **PRECOND))
    tm = StreamerModel(StreamerConfig(**SMALL, **stab, **PRECOND),
                       device="cpu")
    jm.system.use_gather_scatter()
    tm.system.use_gather_scatter()
    u, u_old, u_old1 = _states(jm.space)
    S = jm.system
    (_, u_old_c, d_hist, aux, params_c, bc_shift) = S._cast_inputs(
        jnp.asarray(u_old), jnp.asarray(u_old), jnp.asarray(u_old1), {},
        JaxParams(*map(jnp.asarray, PARAMS)))
    R = S.make_delta_residual_fn(u_old_c, d_hist, aux, params_c, bc_shift)
    ops = tm.system.operators(torch.as_tensor(u_old), torch.as_tensor(u_old1),
                              StepParams(*PARAMS))
    delta = u - u_old
    _assert_close_per_eq(ops.residual(torch.as_tensor(delta)),
                         R(jnp.asarray(delta)), 1e-12)
    v = np.random.default_rng(1).standard_normal(delta.shape)
    _, ref = jax.jvp(R, (jnp.asarray(delta),), (jnp.asarray(v),))
    got = ops.jacobian_action(torch.as_tensor(delta))(torch.as_tensor(v))
    _assert_close_per_eq(got, ref, 1e-12)
    # the stabilisation changes the electron row
    plain = StreamerModel(StreamerConfig(**SMALL, **PRECOND), device="cpu")
    plain.system.use_gather_scatter()
    F0 = plain.system.operators(torch.as_tensor(u_old),
                                torch.as_tensor(u_old1),
                                StepParams(*PARAMS)).residual(
        torch.as_tensor(delta))
    assert not torch.equal(F0[:, 1], ops.residual(torch.as_tensor(delta))[:, 1])


def test_run_from_t0_lands_on_t_final(tmp_path):
    """`StreamerModel.run` from the port's own initial state: each attempt
    clamped to the horizon, so the run ends on T_final exactly, with one
    `relative error.log` line per attempt."""
    tm = StreamerModel(StreamerConfig(**GRADED, dt_init=1.5e-12),
                       device="cpu")
    log = tmp_path / "relative error.log"
    s = tm.run(T_final=4e-12, error_log=log)
    assert s.t == pytest.approx(4e-12, rel=1e-12)
    # 1.5e-12, then the controller's larger step clamped to what is left
    assert s.n_accepted == 2 and s.dt_old == pytest.approx(2.5e-12)
    assert len(log.read_text().splitlines()) == s.n_accepted + s.n_rejected
    assert np.isfinite(s.u.numpy()).all()
