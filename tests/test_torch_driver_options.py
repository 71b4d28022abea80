"""The adaptive driver's options and the Newton options behind them, the
port against the JAX package: the PI34 and H211b controllers,
`restart_bdf_history`, and float64 advances from the same initial state of
the graded 16 x 24 streamer with the predictor, `floor_atol`, `fail_dt_cap`,
`true_res_rescue`, the stall acceptance and a float64 `fallback_system`,
plus `relative error.log` and `newton.log`.

Both packages drive Newton from the host (`host_loop=True`) with the
eager line search (FEDM_TPU_LS_EAGER) and the structured multigrid. Tolerances: the controllers are the same float
expressions and agree to 1e-15 relative; the advances have the same
accept/reject sequence and the same escalation and stall-acceptance counts,
with t, dt and dt_old to 1e-10 relative (measured: at most 4e-12; float64
rounding in another summation order); the log lines have the reference's
format, the same step numbers, exits and iteration counts; the step
errors agree to 1e-9 relative, the initial residual norms to the 6 digits
printed, and the final ones, which sit at the float64 rounding floor of a
residual cancelled up to 1e5-fold (measured: 5.6e-5 relative apart), to
1e-8 of the initial norm.
"""

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu.timestepping import controllers as jax_controllers
from fedm_tpu.timestepping.driver import TimeState as JaxState
from fedm_tpu.timestepping.driver import \
    restart_bdf_history as jax_restart_bdf_history
from fedm_tpu_torch.convert import state_from_arrays, state_to_arrays
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.newton import NewtonConfig
from fedm_tpu_torch.timestepping import (adaptive_timestep_H211b,
                                         adaptive_timestep_PI34,
                                         restart_bdf_history)

GRADED = dict(nx=16, ny=24, density_floor=1e13)
# both packages: the structured multigrid Poisson preconditioner and the
# host-driven Newton
PRECOND = dict(poisson_precond="mg-zline")
HOST_LOOP = dict(host_loop=True)

CONTROLLERS = {"PI34": (adaptive_timestep_PI34,
                        jax_controllers.adaptive_timestep_PI34),
               "H211b": (adaptive_timestep_H211b,
                         jax_controllers.adaptive_timestep_H211b)}


@pytest.mark.parametrize("name", sorted(CONTROLLERS))
@pytest.mark.parametrize("error,dt_old", [
    ([2e-4, 5e-4, 1e-3], 3e-12), ([9e-4, 1e-4, 1e-4], 1e30),
    ([1e-7, 1e-6, 1e-5], None), ([3e-3, 3e-3, 3e-3], 1e-15)],
    ids=["shrinking", "first-step", "no-dt_old", "clamped"])
def test_controllers(name, error, dt_old):
    port, ref = CONTROLLERS[name]
    args = (2e-12, error, 1e-3, 1e-15, 5e-12)
    got, want = port(*args, dt_old=dt_old), ref(*args, dt_old=dt_old)
    assert got == pytest.approx(want, rel=1e-15)


def test_restart_bdf_history():
    rng = np.random.default_rng(0)
    u, u_old, u_old1 = rng.standard_normal((3, 10, 3))
    arrays = dict(u=u, u_old=u_old, u_old1=u_old1, t=1e-9, dt=2e-12,
                  dt_old=3e-12, max_error=np.array([1e-4, 2e-4, 3e-4]),
                  n_accepted=7, n_rejected=2)
    for dt in (None, 5e-13):
        js = jax_restart_bdf_history(JaxState(
            u=jnp.asarray(u), u_old=jnp.asarray(u_old),
            u_old1=jnp.asarray(u_old1), t=1e-9, dt=2e-12, dt_old=3e-12,
            max_error=[1e-4, 2e-4, 3e-4], n_accepted=7, n_rejected=2), dt=dt)
        ts = state_to_arrays(restart_bdf_history(
            state_from_arrays(arrays, device="cpu"), dt=dt))
        for k in ("u", "u_old", "u_old1"):
            np.testing.assert_array_equal(ts[k], np.asarray(getattr(js, k)))
        assert (ts["t"], ts["dt"], ts["dt_old"], ts["n_accepted"]) == (
            js.t, js.dt, js.dt_old, js.n_accepted)


# name: (Newton options, driver options, fallback Newton options, ttol,
#        advances, what the run must show)
SCENARIOS = {
    # a 4-iteration Krylov budget fails some attempts: the fail-dt cap
    # engages, the floor tracks solved steps, the rescue runs
    "rescue-floor-cap": (
        dict(rtol=1e-5, max_iter=2, linear_tol=1e-2, linear_maxiter=4,
             true_res_rescue=1.0),
        dict(predictor=1.0, floor_atol=1.5, fail_dt_cap=0.7), None, 1e-3, 4,
        "capped"),
    # an unreachable rtol: the capped solves are stall-accepted, and a tight
    # ttol rejects on the step error
    "stall-accept-PI34": (
        dict(rtol=1e-7, max_iter=2, linear_tol=1e-2, linear_maxiter=15,
             true_res_rescue=1.0, accept_reduction=3e-2),
        dict(predictor=1.0, floor_atol=1.5, fail_dt_cap=0.7,
             controller="PI34"), None, 1e-5, 3, "stalled"),
    # one Newton iteration never converges: every attempt escalates to the
    # float64 fallback system
    "escalation-H211b": (
        dict(rtol=1e-4, max_iter=1, linear_tol=1e-3, linear_maxiter=100),
        dict(predictor=1.0, escalate_after_rejects=1, controller="H211b"),
        dict(rtol=1e-4, max_iter=20, linear_tol=1e-6, linear_maxiter=200),
        1e-4, 2, "escalated"),
}


def _run(package, newton, drv, fb_newton, ttol, n, logdir, start):
    """`n` advances of one package from the JAX state `start`; returns the
    driver and (t, dt, dt_old, n_accepted, n_rejected) after each."""
    cfg = dict(GRADED, ttol=ttol)
    drv = dict(drv)
    if "controller" in drv:
        drv["controller"] = CONTROLLERS[drv["controller"]][
            0 if package == "port" else 1]
    if package == "jax":
        def model(nw, **kw):
            return JaxModel(JaxConfig(newton=JaxNewton(**nw, **HOST_LOOP),
                                      **cfg, **PRECOND), **kw)
    else:
        def model(nw, **kw):
            return StreamerModel(StreamerConfig(newton=NewtonConfig(
                **nw, **HOST_LOOP), **PRECOND,
                                                **cfg), device="cpu", **kw)
    m = model(newton)
    if fb_newton:
        drv["fallback_system"] = model(fb_newton, mesh=m.mesh).system
    d = m.make_driver(error_log=logdir / f"{package}_error.log",
                      newton_log=logdir / f"{package}_newton.log", **drv)
    s = JaxState(u=start.u, u_old=start.u_old, u_old1=start.u_old1,
                 t=start.t, dt=start.dt, dt_old=start.dt_old)
    if package == "jax":
        def advance(s):
            return d.advance(s, {})
    else:
        s = state_from_arrays(s, device="cpu")
        advance = d.advance
    states = []
    for _ in range(n):
        s = advance(s)
        states.append((s.t, s.dt, s.dt_old, s.n_accepted, s.n_rejected))
    return d, states


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_advances_with_driver_options(scenario, monkeypatch, tmp_path):
    monkeypatch.setenv("FEDM_TPU_LS_EAGER", "1")
    newton, drv, fb, ttol, n, shows = SCENARIOS[scenario]
    # the JAX model's initial state, handed to both packages
    start = JaxModel(JaxConfig(**GRADED, **PRECOND)).initial_state()
    start.dt = 1e-12
    jd, jst = _run("jax", newton, drv, fb, ttol, n, tmp_path, start)
    td, tst = _run("port", newton, drv, fb, ttol, n, tmp_path, start)
    for (jt, jdt, jdo, ja, jr), (tt, tdt, tdo, ta, tr) in zip(jst, tst):
        assert (ta, tr) == (ja, jr)
        for got, want in ((tt, jt), (tdt, jdt), (tdo, jdo)):
            assert got == pytest.approx(want, rel=1e-10)
    assert (td.n_escalated, td.n_stall_accepted) == (jd.n_escalated,
                                                     jd.n_stall_accepted)
    assert (td._dt_cap == jd._dt_cap
            or td._dt_cap == pytest.approx(jd._dt_cap, rel=1e-10))
    shown = {"capped": jd._dt_cap < float("inf") and jst[-1][4] > 0,
             "stalled": jd.n_stall_accepted > 0 and jst[-1][4] > 0,
             "escalated": jd.n_escalated > 0}
    assert shown[shows], f"the scenario did not exercise {shows}"
    _compare_logs(tmp_path)


ERROR_LINE = re.compile(r"^(\S+) +  (\S+) +  (\S+) +$")


def _compare_logs(logdir):
    jlog = (logdir / "jax_error.log").read_text().splitlines(True)
    tlog = (logdir / "port_error.log").read_text().splitlines(True)
    assert len(tlog) == len(jlog) > 0
    for got, want in zip(tlog, jlog):
        g = [float(x) for x in ERROR_LINE.match(got).groups()]
        w = [float(x) for x in ERROR_LINE.match(want).groups()]
        # the reference's columns: each number left-aligned in 23
        assert got == f"{g[0]:<23}  {g[1]:<23}  {g[2]:<23}\n"
        np.testing.assert_allclose(g, w, rtol=1e-9)
    jn = (logdir / "jax_newton.log").read_text().splitlines()
    tn = (logdir / "port_newton.log").read_text().splitlines()
    assert len(tn) == len(jn) > 0
    for got, want in zip(tn, jn):
        g, w = got.split(" "), want.split(" ")
        assert len(g) == len(w) == 6 and g[:3] == w[:3]
        assert all(re.fullmatch(r"-?\d\.\d{6}e[+-]\d\d", x) for x in g[3:])
        # res0 to the 6 digits printed; res, at the float64 rounding floor
        # of a residual cancelled 1e5-fold, to 1e-8 of res0; dt to 1e-10
        g0, w0 = float(g[3]), float(w[3])
        assert g0 == pytest.approx(w0, rel=2e-6)
        assert abs(float(g[4]) - float(w[4])) <= 1e-8 * w0
        assert float(g[5]) == pytest.approx(float(w[5]), rel=1e-10)


def test_crash_checkpoint_carries_meta(tmp_path):
    """A dt_min death saves the last good state with the run's meta."""
    from fedm_tpu_torch.io import load_checkpoint

    m = StreamerModel(StreamerConfig(
        newton=NewtonConfig(rtol=1e-12, max_iter=1, linear_maxiter=2,
                            **HOST_LOOP),
        dt_min=2.5e-13, **GRADED, **PRECOND), device="cpu")
    meta = {"z_corridor": (1e-3, 2e-3, 1e-5),
            "protocol": json.dumps({"preset": None})}
    d = m.make_driver(crash_checkpoint=tmp_path / "crash.npz",
                      crash_meta=lambda: meta)
    s = m.initial_state()
    s.dt = 1e-12
    with pytest.raises(SystemExit, match="Minimum time-step"):
        d.advance(s)
    got, got_meta = load_checkpoint(tmp_path / "crash.npz", device="cpu",
                                    with_meta=True)
    np.testing.assert_array_equal(got.u.numpy(), s.u.numpy())
    assert got.n_rejected == 3 and got.t == 0.0
    assert tuple(got_meta["z_corridor"]) == meta["z_corridor"]
    assert str(got_meta["protocol"]) == meta["protocol"]
