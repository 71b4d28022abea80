"""The batched sweep's option paths: transport z-lines (`tzline`:
poisson_precond "mg-zline", transport_zline) and row equilibration in
float32 (`row_scaled_f32`), the configurations of
`tools/port_reference_options.py`, on StreamerConfig(nx=10, ny=14) with
seed amplitudes 2e18, 5e18, 1e19 and three lockstep attempts, against the
JAX package's sweep (`vmap` of its `CoupledSystem._step`) from the JAX
package's initial states, and each member against the port's
single-system `step`.

Tolerances, measured on the CPU:
- tzline: `tests/test_torch_sweep.py`'s (counts equal; t and dt 1e-12
  relative, gap 0; max_error 1e-12, gap 7.3e-14; states 1e-13 of each
  column's max, gap 2.9e-16); each member equals its single step bit for
  bit (gap 0), held at 1e-13.
- row_scaled_f32: counts, t and dt as above (gap 0). The float32 Newton
  and Krylov loops round otherwise in the two packages, so max_error, a
  ratio of differences of the float32 increments, is held to 2e-3 (gap
  2.3e-4) and the states to 2e-5 of each column's max (gap 2.1e-6). A
  member against its single step: the batch scatters through the ELL
  table, the single system through its own layout, in float32: 1e-8 of
  each column's max (gaps 1.4e-11 to 2.5e-10).

Controls, each refused by the tolerance it tests: the tz-line batch with
its z-line solves replaced by the node-block answer; the row-scaled batch
without its weights; and, with `row_scaled_atol_rel` > 0 on members whose
norms differ 100x, one absolute target shared by the members (the
largest member's): the smaller member then stops after one Newton
iteration, where its own target takes two.
"""

from unittest import mock

import jax.numpy as jnp
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
from fedm_tpu_torch.parallel import BatchedSweep

AMPS = [2e18, 5e18, 1e19]
N_ATTEMPTS = 3
OPTIONS = {"tzline": dict(poisson_precond="mg-zline", transport_zline=True),
           "row_scaled_f32": dict(row_scaled=True)}
T_RTOL = 1e-12
# (max_error, state, member against its single step), see the docstring
TOLS = {"tzline": (1e-12, 1e-13, 1e-13),
        "row_scaled_f32": (2e-3, 2e-5, 1e-8)}
FIELDS = ("u", "u_old", "u_old1", "t", "dt", "dt_old", "max_error",
          "n_accepted", "n_rejected")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _f32(name: str) -> bool:
    return name.endswith("f32")


@pytest.fixture(scope="module", params=list(OPTIONS))
def case(request):
    """(option name, the JAX sweep's start and end, the port's model and
    sweep)."""
    name = request.param
    jdt = {"dtype": jnp.float32} if _f32(name) else {}
    cfg = JaxConfig(nx=10, ny=14, **OPTIONS[name], **jdt)
    states = [JaxModel(JaxConfig(nx=10, ny=14, seed_amplitude=a,
                                 **OPTIONS[name], **jdt)).initial_state()
              for a in AMPS]
    sw = JaxSweep(JaxModel(cfg).system, monitor_idx=1, ttol=cfg.ttol,
                  dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    st = sw.from_states(states)
    start = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    for _ in range(N_ATTEMPTS):
        st = sw.attempt(st, {})
    ref = {k: np.asarray(getattr(st, k)) for k in FIELDS}
    tdt = {"dtype": torch.float32} if _f32(name) else {}
    tcfg = StreamerConfig(nx=10, ny=14, **OPTIONS[name], **tdt)
    model = StreamerModel(tcfg, device="cpu")
    sweep = BatchedSweep(model.system, monitor_idx=1, ttol=tcfg.ttol,
                         dt_min=tcfg.dt_min, dt_max=tcfg.dt_max)
    return name, start, ref, model, sweep


def _run(sweep, start):
    st = sweep_state_from_arrays(start, device="cpu")
    for _ in range(N_ATTEMPTS):
        st = sweep.attempt(st, {})
    return st


def _gaps(st, ref):
    """Per member: (max_error rel. gap, state gap rel. to each column's
    max)."""
    err = np.max(np.abs(st.max_error - ref["max_error"])
                 / np.abs(ref["max_error"]), axis=1)
    scale = np.abs(ref["u"]).max(axis=1, keepdims=True)
    state = np.max(np.abs(st.u.numpy() - ref["u"]) / scale, axis=(1, 2))
    return err, state


def test_sweep_matches_the_jax_sweep(case):
    name, start, ref, _, sweep = case
    st = _run(sweep, start)
    assert (st.n_accepted == ref["n_accepted"]).all()
    assert (st.n_rejected == ref["n_rejected"]).all()
    assert st.n_accepted.sum() > 0
    np.testing.assert_allclose(st.t, ref["t"], rtol=T_RTOL, atol=0)
    np.testing.assert_allclose(st.dt, ref["dt"], rtol=T_RTOL, atol=0)
    err, state = _gaps(st, ref)
    err_tol, state_tol, _ = TOLS[name]
    assert (err <= err_tol).all(), err
    assert (state <= state_tol).all(), state


def test_control_is_refused(case):
    """tzline without its z-line solves (the node-block answer on the
    electron rows), row_scaled_f32 without its weights: the attempts
    leave the JAX sweep's tolerances in some member."""
    name, start, ref, model, sweep = case
    if name == "tzline":
        patch = mock.patch.object(sweep.batched(len(AMPS)), "_tzline", None)
    else:
        patch = mock.patch.object(model.system, "row_weights",
                                  lambda ops, d: torch.ones_like(d))
    with patch:
        st = _run(sweep, start)
    err, state = _gaps(st, ref)
    err_tol, state_tol, _ = TOLS[name]
    counts = ((st.n_accepted == ref["n_accepted"]).all()
              and (st.n_rejected == ref["n_rejected"]).all())
    assert not (counts and (err <= err_tol).all()
                and (state <= state_tol).all()), (err, state)


def _members_vs_single(sweep, system, u, u_old1, params):
    """Per member: (batched Newton iterations, single ones, both verdicts,
    the state gap rel. to each column's max)."""
    u_b, info_b = sweep.batched(u.shape[0]).step(u, u, u_old1, {}, params)
    out = []
    for b in range(u.shape[0]):
        u_s, info_s = system.step(u[b], u[b], u_old1[b], {},
                                  StepParams(*(float(x[b]) for x in params)))
        scale = u_s.abs().amax(dim=0)
        out.append((int(info_b.iters[b]), int(info_s.iters),
                    bool(info_b.converged[b]), bool(info_s.converged),
                    float(((u_b[b] - u_s).abs().amax(dim=0) / scale).max())))
    return out


def test_members_match_single_steps(case):
    """Each member's attempt equals the port's single-system `step` from
    the same state at the same parameters: the same Newton iterations and
    verdict, the state within the member tolerance."""
    name, start, _, model, sweep = case
    st = sweep.attempt(sweep_state_from_arrays(start, device="cpu"), {})
    params = StepParams(st.t + st.dt, st.dt, st.dt_old)
    rows = _members_vs_single(sweep, model.system, st.u, st.u_old1, params)
    for it_b, it_s, conv_b, conv_s, gap in rows:
        assert it_b == it_s > 0 and conv_b == conv_s
        assert gap <= TOLS[name][2], rows


@pytest.fixture(scope="module")
def atol_case():
    """Row-scaled float64 members with `row_scaled_atol_rel` > 0: the
    initial state with its potential scaled by 100 (off its boundary
    values, its norm 100x), and the initial state."""
    cfg = StreamerConfig(nx=10, ny=14, row_scaled=True)
    model = StreamerModel(cfg, device="cpu")
    model.system.row_scaled_atol_rel = ATOL_REL
    s0 = model.initial_state()
    u0 = s0.u.clone()
    u0[:, 2] *= 100.0
    u = torch.stack([u0, s0.u])
    sweep = BatchedSweep(model.system, monitor_idx=1, ttol=cfg.ttol,
                         dt_min=cfg.dt_min, dt_max=cfg.dt_max)
    params = StepParams(np.full(2, 1e-12), np.full(2, 1e-12),
                        np.full(2, 1e30))
    return model, sweep, u, params


ATOL_REL = 1e-11


def test_row_scaled_atol_is_per_member(atol_case):
    model, sweep, u, params = atol_case
    norms = torch.linalg.vector_norm(u.reshape(2, -1), dim=1)
    assert float(norms[0] / norms[1]) > 99
    rows = _members_vs_single(sweep, model.system, u, u, params)
    for it_b, it_s, conv_b, conv_s, gap in rows:
        assert it_b == it_s > 0 and conv_b and conv_s
        assert gap <= TOLS["tzline"][2], rows
    assert rows[1][0] == 2, rows


def test_shared_atol_is_refused(atol_case):
    """The control: every member's absolute target the largest one."""
    model, sweep, u, params = atol_case
    solve = tsys.newton_krylov_batched

    def shared(*a, atol, **kw):
        return solve(*a, atol=np.full_like(atol, atol.max()), **kw)

    with mock.patch.object(tsys, "newton_krylov_batched", shared):
        rows = _members_vs_single(sweep, model.system, u, u, params)
    assert any(it_b != it_s or gap > TOLS["tzline"][2]
               for it_b, it_s, _, _, gap in rows), rows
