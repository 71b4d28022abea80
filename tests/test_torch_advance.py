"""The slice as a whole: adaptive BDF2 advances of the port against the JAX
package on the small corridor configuration of tests/unit/test_geom_mode.py
(float32 compute, float64 defect, host-driven Newton — the bench's solver
structure), from the same state: the JAX model's initial state with a
small first dt, so the PID controller grows dt without hitting dt_max.

Tolerances (float32 compute): the accept/reject sequence is identical; dt
agrees to 5e-6 relative and the fields to 1e-6 of each component's
magnitude. Two float32 BiCGStab solves of the same system in another
summation order agree only to ~4e-4 relative in the ion row after five
iterations (measured on this state), so the accepted increments differ at
the 1e-5 level; the monitored step error carries that into the next dt
through the controller's error^-0.26 (measured: at most 1.79e-6
relative over the three advances, so the limit is ~3x that). The
float64-compute run of the same path (test_torch_advance_f64.py) holds dt
to 1e-10, which isolates the gap as float32 rounding."""

import jax.numpy as jnp
import numpy as np
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu_torch.convert import state_from_arrays, state_to_arrays
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.newton import NewtonConfig

SMALL = dict(z_corridor=(7e-3, 8.5e-3, 5e-5), r_corridor=(2e-3, 2e-4),
             z_tail_cells=(12, 12), mg_levels=3, density_floor=1e13)
# both packages: the structured multigrid Poisson preconditioner and
# (below) Newton driven from the host, which the bench configuration sets
PRECOND = dict(poisson_precond="mg-zline")
NEWTON = dict(rtol=1e-3, max_iter=20, linear_tol=1e-4, linear_maxiter=200,
              accept_reduction=3e-2, hi_residual=True)
HOST_LOOP = dict(host_loop=True)
N_ADVANCES = 3
FIRST_DT = 1e-13


def run_both(monkeypatch, jax_dtype, torch_dtype):
    """N_ADVANCES advances of each package from the same state; returns the
    per-advance (JAX state, port state as numpy arrays) pairs."""
    # the bench's line-search structure (bench.py sets it the same way)
    monkeypatch.setenv("FEDM_TPU_LS_EAGER", "1")
    jm = JaxModel(JaxConfig(newton=JaxNewton(**NEWTON, **HOST_LOOP),
                            dtype=jax_dtype, **SMALL, **PRECOND))
    tm = StreamerModel(StreamerConfig(newton=NewtonConfig(**NEWTON,
                                                          **HOST_LOOP),
                                      dtype=torch_dtype, **SMALL, **PRECOND),
                       device="cpu")
    jm.system.use_gather_scatter()
    tm.system.use_gather_scatter()
    js = jm.initial_state()
    js.dt = FIRST_DT
    ts = state_from_arrays(js, device="cpu")
    jd, td = jm.make_driver(), tm.make_driver()
    out = []
    for _ in range(N_ADVANCES):
        js = jd.advance(js, {})
        ts = td.advance(ts)
        out.append((js, state_to_arrays(ts)))
    return out


def check_trajectories(pairs, dt_rtol, field_rtol):
    for js, ts in pairs:
        assert (ts["n_accepted"], ts["n_rejected"]) == (js.n_accepted,
                                                        js.n_rejected)
        assert abs(ts["t"] - js.t) <= dt_rtol * js.t
        assert abs(ts["dt"] - js.dt) <= dt_rtol * js.dt
        assert abs(ts["dt_old"] - js.dt_old) <= dt_rtol * js.dt_old
        for name in ("u", "u_old"):
            ref = np.asarray(getattr(js, name))
            got = ts[name]
            assert np.isfinite(got).all()
            for k in range(ref.shape[1]):
                scale = np.abs(ref[:, k]).max()
                assert np.abs(got[:, k] - ref[:, k]).max() <= \
                    field_rtol * scale, (name, k)


def test_three_advances_float32_hi_residual(monkeypatch):
    pairs = run_both(monkeypatch, jnp.float32, torch.float32)
    assert pairs[-1][0].n_accepted == N_ADVANCES
    assert pairs[-1][0].dt > 10 * FIRST_DT  # the controller did grow dt
    check_trajectories(pairs, dt_rtol=5e-6, field_rtol=1e-6)
