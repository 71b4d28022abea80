"""The two Newton drive modes and the driver's predictor gate, the port
against the JAX package on the graded 16 x 24 streamer (structured
multigrid on the Poisson row in both packages).

`CoupledSystem.step` runs the host loop only with `NewtonConfig.host_loop`
and no row scaling, and the driver predicts a guess only into such a
system; every other system runs `newton_krylov` from u_old. The float32
primary here (float64 defect, host loop, predictor 1.0) escalates to a
float64 fallback built on the default NewtonConfig, which runs
`newton_krylov`: its attempts must start from u_old, not from the
predicted guess.

Tolerances, from the same JAX state after one plain advance:
- escalated advance (escalate_after_rejects=0: every attempt in the
  float64 fallback): t and dt to 2e-8 relative, each column's increment
  u_new - u_old to 5e-8 of its largest entry (measured: dt 1e-14, the
  increments <= 1.1e-9; a fallback started from the predicted guess gives
  dt 6.3e-8 and the electron and potential increments 5e-7 and 1.2e-7);
- one rejection on the step error (ttol 1e-5) then the rejection-rate
  trigger (escalate_after_rejects=1): the same limits (measured: t 3.7e-9
  and dt 4.5e-9, from the float32 first attempt's step error, the
  increments <= 6e-9; from the guess dt 7.7e-8, increments 4.3e-7 and
  above). The error is linear in dt here, so the controller's retry at
  0.5 * ttol / error always passes: no ttol rejects two attempts in a row
  of this run, and one rejection arms the trigger instead.
- `newton_krylov` on the float64 default from the initial state: the same
  counts, t and dt to 1e-12 and the fields to 1e-12 of each column's
  magnitude (float64 rounding in another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu.solvers.newton import newton_converged as jax_converged
from fedm_tpu_torch.convert import state_from_arrays, state_to_arrays
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.newton import NewtonConfig, newton_converged

GRADED = dict(nx=16, ny=24, density_floor=1e13, poisson_precond="mg-zline")
PRIMARY = dict(rtol=1e-3, max_iter=20, linear_tol=1e-4, linear_maxiter=200,
               accept_reduction=3e-2, hi_residual=True, host_loop=True)
FIRST_DT = 1e-13
STEP_RTOL = 2e-8
INCREMENT_RTOL = 5e-8


@pytest.fixture(autouse=True)
def _eager_line_search(monkeypatch):
    # the port's line-search structure (the lam = 1 probe first)
    monkeypatch.setenv("FEDM_TPU_LS_EAGER", "1")


@pytest.fixture(scope="module")
def systems():
    """Per package: (primary model, its float64 default fallback system),
    built once (the JAX package's compiled steps are kept on them)."""
    out = {}
    m = JaxModel(JaxConfig(dtype=jnp.float32, newton=JaxNewton(**PRIMARY),
                           **GRADED))
    out["jax"] = (m, JaxModel(JaxConfig(**GRADED), mesh=m.mesh))
    m = StreamerModel(StreamerConfig(dtype=torch.float32,
                                     newton=NewtonConfig(**PRIMARY),
                                     **GRADED), device="cpu")
    out["port"] = (m, StreamerModel(StreamerConfig(**GRADED), mesh=m.mesh,
                                    device="cpu"))
    for m, fb in out.values():
        m.system.use_gather_scatter()
        fb.system.use_gather_scatter()
    return out


def _driver(systems, package):
    m, fb = systems[package]
    return m.make_driver(fallback_system=fb.system, predictor=1.0)


@pytest.fixture(scope="module")
def after_one_advance(systems):
    """The JAX state after one plain advance (dt_old is set)."""
    import os

    os.environ["FEDM_TPU_LS_EAGER"] = "1"
    try:
        s = systems["jax"][0].initial_state()
        s.dt = FIRST_DT
        s = _driver(systems, "jax").advance(s, {})
    finally:
        del os.environ["FEDM_TPU_LS_EAGER"]
    assert s.n_accepted == 1 and 0.0 < s.dt_old < 1e29
    return s


@pytest.mark.parametrize("escalate_after_rejects,ttol,rejected", [
    (0, 1e-3, 0), (1, 1e-5, 1)], ids=["every-attempt", "after-a-reject"])
def test_escalated_attempts_start_from_u_old(systems, after_one_advance,
                                             escalate_after_rejects, ttol,
                                             rejected):
    start = after_one_advance
    out = {}
    for package in ("jax", "port"):
        d = _driver(systems, package)
        d.escalate_after_rejects = escalate_after_rejects
        d.ttol = ttol
        if package == "jax":
            s = d.advance(start, {})
            out[package] = (s.t, s.dt, s.n_accepted, s.n_rejected,
                            np.asarray(s.u), d.n_escalated)
        else:
            s = state_to_arrays(d.advance(state_from_arrays(start,
                                                            device="cpu")))
            out[package] = (s["t"], s["dt"], s["n_accepted"],
                            s["n_rejected"], s["u"], d.n_escalated)
    (jt, jdt, jacc, jrej, ju, jesc), (tt, tdt, tacc, trej, tu, tesc) = (
        out["jax"], out["port"])
    assert (tacc, trej, tesc) == (jacc, jrej, jesc) == (2, rejected, 1)
    assert abs(tt - jt) <= STEP_RTOL * jt
    assert abs(tdt - jdt) <= STEP_RTOL * jdt
    u0 = np.asarray(start.u)
    for k in range(3):
        scale = np.abs(ju[:, k] - u0[:, k]).max()
        assert np.abs(tu[:, k] - ju[:, k]).max() <= INCREMENT_RTOL * scale, k


def test_newton_krylov_float64_default():
    """The float64 StreamerConfig default sets no host_loop: both packages
    solve with the whole-solve loop."""
    jm = JaxModel(JaxConfig(**GRADED))
    tm = StreamerModel(StreamerConfig(**GRADED), device="cpu")
    assert not tm.cfg.newton.host_loop and not jm.cfg.newton.host_loop
    js = jm.initial_state()
    js.dt = FIRST_DT
    ts = state_from_arrays(js, device="cpu")
    jd, td = jm.make_driver(predictor=1.0), tm.make_driver(predictor=1.0)
    for _ in range(2):
        js = jd.advance(js, {})
        ts = td.advance(ts)
        got = state_to_arrays(ts)
        assert (got["n_accepted"], got["n_rejected"]) == (js.n_accepted,
                                                          js.n_rejected)
        for key in ("t", "dt"):
            ref = getattr(js, key)
            assert abs(got[key] - ref) <= 1e-12 * ref
        ref = np.asarray(js.u)
        for k in range(3):
            assert np.abs(got["u"][:, k] - ref[:, k]).max() <= \
                1e-12 * np.abs(ref[:, k]).max(), k


@pytest.mark.parametrize("fnorm,step_ok,stalls,capped", [
    (20.0, True, 0, False), (20.0, False, 0, False), (0.5, False, 0, False),
    (float("nan"), True, 0, False), (40.0, True, 2, True)])
def test_newton_verdict_with_stol(fnorm, step_ok, stalls, capped):
    """The stol criterion converges an iteration whose full step fell
    below stol * ||iterate||, as in the JAX package's verdict."""
    cfg = dict(rtol=1e-3, stol=1e-3, max_stalls=2)
    got = newton_converged(fnorm, 1000.0, 1.0, stalls, NewtonConfig(**cfg),
                           capped, step_ok)
    ref = jax_converged(fnorm, 1000.0, 1.0, stalls, step_ok,
                        JaxNewton(**cfg), capped)
    assert got == bool(ref)
