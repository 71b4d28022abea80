"""Row equilibration (`row_scaled`), the port against the JAX package on
the graded 16 x 24 streamer: the row weights 1 / (assembled l1 row norm)
and one advance in float64 and in float32, where the JAX package sets
stol = 1e-3. Both run `newton_krylov` without the float64 defect.

Tolerances: the weights are float64 sums of |tangents| in another order
(1e-12 relative; float32 1e-6); the float64 advance has the same counts,
dt and fields to 1e-10 relative; the float32 advance the same outcome.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JaxParams
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu_torch.convert import state_from_arrays, state_to_arrays
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel

GRADED = dict(nx=16, ny=24, density_floor=1e13, poisson_precond="mg-zline",
              row_scaled=True)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_row_weights(dtype):
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    jm = JaxModel(JaxConfig(dtype=jdt, **GRADED))
    tm = StreamerModel(StreamerConfig(dtype=tdt, **GRADED), device="cpu")
    assert tm.system.row_scaled
    js = jm.initial_state()
    p = (1e-12, 1e-12, 1e30)
    jp = JaxParams(*(jnp.asarray(x) for x in p))
    args = jm.system._cast_inputs(js.u, js.u, js.u_old1, {}, jp)[:5]
    w_ref = np.asarray(jm.system._row_weights(*args))
    ts = state_from_arrays(js, device="cpu")
    ops = tm.system.operators(ts.u, ts.u_old1, StepParams(*p))
    w = tm.system.row_weights(ops, torch.zeros_like(ts.u, dtype=tdt))
    assert w.dtype == tdt
    rtol = 1e-12 if dtype == "f64" else 1e-6
    np.testing.assert_allclose(w.numpy(), w_ref, rtol=rtol, atol=0)
    assert (w.numpy()[tm.system.bcs.mask.numpy()] == 1.0).all()


def _outcome(advance, state):
    """(the advanced state, None) or (None, the driver's exit message)."""
    try:
        return advance(state), None
    except SystemExit as exc:
        return None, str(exc)


@pytest.mark.parametrize("dtype,atol_rel", [("f64", 0.0), ("f32", 0.0),
                                            ("f64", 1e-9)],
                         ids=["f64", "f32", "f64-atol"])
def test_one_step(dtype, atol_rel):
    """float64: the same step, also with the state-relative absolute
    target `row_scaled_atol_rel`. float32: the same outcome, whatever it is
    (on this state the equilibrated float32 system converges in neither
    package, and the controller walks dt into dt_min)."""
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    jm = JaxModel(JaxConfig(dtype=jdt, **GRADED))
    tm = StreamerModel(StreamerConfig(dtype=tdt, **GRADED), device="cpu")
    jm.system.row_scaled_atol_rel = tm.system.row_scaled_atol_rel = atol_rel
    js = jm.initial_state()
    js.dt = 1e-12
    ts = state_from_arrays(js, device="cpu")
    jd, td = jm.make_driver(predictor=1.0), tm.make_driver(predictor=1.0)
    if dtype == "f32":
        # three failed attempts reach it: the same outcome, sooner
        jd.dt_min = td.dt_min = 2e-13
    js, jexit = _outcome(lambda s: jd.advance(s, {}), js)
    ts, texit = _outcome(td.advance, ts)
    assert texit == jexit
    if dtype == "f32":
        assert jexit is not None and "Minimum time-step" in jexit
        return
    got = state_to_arrays(ts)
    assert (got["n_accepted"], got["n_rejected"]) == (js.n_accepted,
                                                      js.n_rejected)
    assert abs(got["dt"] - js.dt) <= 1e-10 * js.dt
    ref = np.asarray(js.u)
    for k in range(3):
        assert np.abs(got["u"][:, k] - ref[:, k]).max() <= \
            1e-10 * np.abs(ref[:, k]).max(), k
