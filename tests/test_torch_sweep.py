"""The batched sweep (`fedm_tpu_torch.parallel.BatchedSweep`) against the
JAX package's, in the scenario of
`tests/parallel/test_sweep.py::test_batched_sweep_matches_single_runs`:
StreamerConfig(nx=10, ny=14), seed amplitudes 2e18, 5e18, 1e19, three
lockstep attempts. Both packages start from the JAX package's initial
states (moved with `convert.sweep_state_from_arrays`, exactly).

Tolerances, measured on the CPU (tools/port_reference_sweep.py --port
--nx 10 --ny 14 --amps 2e18,5e18,1e19): per member, n_accepted and
n_rejected equal, t and dt within 1e-12 relative (gap 0), max_error
within 1e-12 relative (gap 5.2e-15) and each state column within 1e-13 of
its max (gap 5.2e-16). The control, the same batch solved by one
Newton-BiCGStab over the stacked block-diagonal system with its scalars
and norms shared across the members, is refused by both: its max_error
gaps are 3e-11 to 1.3e-3 and its state gaps 2.3e-12 to 8.9e-6, in every
member."""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
import fedm_tpu_torch.model.system as tsys
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.parallel import BatchedSweep as JaxSweep
from fedm_tpu_torch.convert import sweep_state_from_arrays
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.parallel import BatchedSweep, SweepState
from fedm_tpu_torch.solvers.newton import NewtonInfo, newton_krylov

AMPS = [2e18, 5e18, 1e19]
N_ATTEMPTS = 3
T_RTOL, ERR_RTOL, STATE_RTOL = 1e-12, 1e-12, 1e-13
FIELDS = ("u", "u_old", "u_old1", "t", "dt", "dt_old", "max_error",
          "n_accepted", "n_rejected")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run():
    cfg = JaxConfig(nx=10, ny=14)
    model = JaxModel(cfg)
    states = [JaxModel(JaxConfig(nx=10, ny=14, seed_amplitude=a))
              .initial_state() for a in AMPS]
    sw = JaxSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                  dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    st = sw.from_states(states)
    start = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    for _ in range(N_ATTEMPTS):
        st = sw.attempt(st, {})
    return start, {k: np.asarray(getattr(st, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def port():
    cfg = StreamerConfig(nx=10, ny=14)
    model = StreamerModel(cfg, device="cpu")
    sweep = BatchedSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                         dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    return model, sweep


def _run(sweep, start, n=N_ATTEMPTS) -> SweepState:
    st = sweep_state_from_arrays(start, device="cpu")
    for _ in range(n):
        st = sweep.attempt(st, {})
    return st


def _shared_scalars(residual, jac, delta, config, pb, residual_hi=None,
                    active=None):
    """The control: one `newton_krylov` over the stacked members."""
    d, info = newton_krylov(residual, jac, delta, config, pb, residual_hi)
    return d, NewtonInfo(*(np.full(delta.shape[0], x) for x in info))


def _gaps(st: SweepState, ref: dict):
    """Per member: (max_error rel. gap, state gap rel. to each column's
    max)."""
    err = np.max(np.abs(st.max_error - ref["max_error"])
                 / np.abs(ref["max_error"]), axis=1)
    u = st.u.numpy()
    scale = np.abs(ref["u"]).max(axis=1, keepdims=True)
    state = np.max(np.abs(u - ref["u"]) / scale, axis=(1, 2))
    return err, state


def test_sweep_state_moves_exactly(jax_run):
    start, _ = jax_run
    st = sweep_state_from_arrays(start, device="cpu")
    for k in ("u", "u_old", "u_old1"):
        assert np.array_equal(getattr(st, k).numpy(), start[k])
    for k in ("t", "dt", "dt_old", "max_error", "n_accepted",
              "n_rejected"):
        assert np.array_equal(getattr(st, k), start[k]), k


def test_sweep_matches_the_jax_sweep(jax_run, port):
    start, ref = jax_run
    st = _run(port[1], start)
    assert (st.n_accepted == ref["n_accepted"]).all()
    assert (st.n_rejected == ref["n_rejected"]).all()
    assert (st.n_accepted == N_ATTEMPTS).all()
    np.testing.assert_allclose(st.t, ref["t"], rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(st.dt, ref["dt"], rtol=T_RTOL, atol=0)
    err, state = _gaps(st, ref)
    assert (err <= ERR_RTOL).all(), err
    assert (state <= STATE_RTOL).all(), state
    # independent physics: the members' errors differ
    assert len(np.unique(np.round(st.max_error[:, 0], 12))) == len(AMPS)


def test_shared_scalars_control_is_refused(jax_run, port):
    start, ref = jax_run
    with mock.patch.object(tsys, "newton_krylov_batched", _shared_scalars):
        st = _run(port[1], start)
    err, state = _gaps(st, ref)
    assert (err > ERR_RTOL).all(), err
    assert (state > STATE_RTOL).all(), state


def test_members_match_single_steps(jax_run, port):
    """Each member's attempt equals the port's single-system `step` from
    the same state at the same parameters, with the same Newton count."""
    model, sweep = port
    start, _ = jax_run
    st = sweep_state_from_arrays(start, device="cpu")
    st = sweep.attempt(st, {})        # a non-trivial BDF2 history
    params = StepParams(st.t + st.dt, st.dt, st.dt_old)
    u_b, info_b = sweep.batched(len(AMPS)).step(st.u, st.u, st.u_old1, {},
                                                params)
    for b in range(len(AMPS)):
        u_s, info_s = model.system.step(
            st.u[b], st.u[b], st.u_old1[b], {},
            StepParams(*(float(x[b]) for x in params)))
        assert int(info_b.iters[b]) == int(info_s.iters) > 0
        assert bool(info_b.converged[b]) and bool(info_s.converged)
        scale = u_s.abs().amax(dim=0)
        assert float(((u_b[b] - u_s).abs().amax(dim=0) / scale).max()) \
            <= STATE_RTOL


def test_inactive_members_are_frozen(jax_run, port):
    start, _ = jax_run
    sweep = port[1]
    st0 = sweep_state_from_arrays(start, device="cpu")
    st = sweep.attempt(st0, {}, active=np.array([True, False, True]))
    assert list(st.n_accepted) == [1, 0, 1]
    for k in ("u", "u_old", "u_old1"):
        assert torch.equal(getattr(st, k)[1], getattr(st0, k)[1])
    assert (st.t[1], st.dt[1], st.dt_old[1]) == (st0.t[1], st0.dt[1],
                                                 st0.dt_old[1])
    assert list(st.max_error[1]) == list(st0.max_error[1])
    # the active members advanced as in a full attempt
    full = sweep.attempt(st0, {})
    for b in (0, 2):
        assert torch.equal(st.u[b], full.u[b])


def test_run_until_lands_on_the_horizon(jax_run, port):
    start, _ = jax_run
    sweep = port[1]
    T = 1.2e-11    # not a multiple of the members' dt (5e-12)
    st = sweep.run_until(sweep_state_from_arrays(start, device="cpu"), T,
                         {})
    np.testing.assert_allclose(st.t, T, rtol=1e-12, atol=0)
    assert (st.n_accepted == 3).all() and (st.n_rejected == 0).all()
    # the last attempt ran at the clamped dt = T - 1e-11
    np.testing.assert_allclose(st.dt_old, T - 1e-11, rtol=1e-9)
    # a member already at the horizon is not stepped again
    st2 = sweep.run_until(st, T, {})
    assert (st2.n_accepted == 3).all()


def test_dt_min_death_names_the_member(jax_run):
    start, _ = jax_run
    cfg = StreamerConfig(nx=10, ny=14)
    model = StreamerModel(cfg, device="cpu")
    # a tolerance no step meets: every attempt is rejected, and the
    # halved dt falls below dt_min
    sweep = BatchedSweep(model.system, monitor_idx=1, ttol=1e-12,
                         dt_min=1e-12, dt_max=cfg.dt_max)
    st = sweep_state_from_arrays(start, device="cpu")
    with pytest.raises(SystemExit, match=r"simulation 2\)"):
        sweep.attempt(st, {}, active=np.array([False, False, True]))


def test_batch_sharding(port):
    model = port[0]
    with pytest.raises(NotImplementedError, match="distinct devices"):
        BatchedSweep(model.system, 1, 1e-3, 1e-15, 5e-12,
                     batch_sharding=["cpu", "meta"])
    with pytest.raises(ValueError, match="lives on cpu"):
        BatchedSweep(model.system, 1, 1e-3, 1e-15, 5e-12,
                     batch_sharding="meta")
    sw = BatchedSweep(model.system, 1, 1e-3, 1e-15, 5e-12,
                      batch_sharding=["cpu", "cpu"])
    st = sw.from_states([model.initial_state()] * 2)
    assert st.u.shape[0] == 2 and st.u.device.type == "cpu"
    assert jax.devices()[0].platform == "cpu"
