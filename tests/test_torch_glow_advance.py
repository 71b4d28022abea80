"""The glow slice as a whole: adaptive BDF2 advances of the port's glow
discharge against the JAX package's on the crossed 8 x 8 mesh, from each
package's own initial state (identical), each advance fed its own
package's per-advance coefficients (`_update_aux`); a checkpoint written by
the JAX package read back by the port; and the streamer's advance with the
empty aux it always had.

Tolerances, measured on the CPU:
- float64 (the JAX default Newton settings, host-driven): dt agrees to
  7.5e-11 relative over the three advances and the fields to 1e-12 of each
  component's magnitude; the limits are 1e-10 (dt) and 1e-10 (fields).
  The step error is a ratio of small differences, so the Newton
  solutions' last-digit differences reach dt at the 1e-11 level.
- float32 with the float64 defect (the glow50 Newton settings): the two
  packages' float32 Krylov solves and the float32 CG of `project` differ
  by rounding; measured gaps 2.6e-8 in dt, 1.8e-11 in the log-densities
  and 7.5e-8 in the potential; the limits are 1e-7, 1e-10 and 3e-7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from fedm_tpu.model.system import StepParams as JaxParams
from fedm_tpu.models.argon_synth import generate_argon_input
from fedm_tpu.models.glow import GlowConfig as JaxConfig
from fedm_tpu.models.glow import GlowDischargeModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu_torch.convert import state_to_arrays
from fedm_tpu_torch.io import load_checkpoint
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.glow import GlowConfig, GlowDischargeModel
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.newton import NewtonConfig

N = 8
N_ADVANCES = 3
# the JAX package's float64 PlasmaConfig default and the glow50 protocol
NEWTON = {
    "f64": dict(rtol=1e-4, max_iter=20, linear_tol=1e-6,
                linear_maxiter=1500),
    "f32": dict(rtol=1e-3, max_iter=20, linear_tol=1e-2, linear_maxiter=600,
                hi_residual=True),
}
DTYPES = {"f64": (jnp.float64, torch.float64),
          "f32": (jnp.float32, torch.float32)}
# (dt, log-densities, potential) relative limits; see the module docstring
LIMITS = {"f64": (1e-10, 1e-10, 1e-10), "f32": (1e-7, 1e-10, 3e-7)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("argon")
    generate_argon_input(base)
    return base


def _models(tree, kind):
    jdt, tdt = DTYPES[kind]
    jm = JaxModel(JaxConfig(file_input=tree, nx=N, ny=N, dtype=jdt,
                            newton=JaxNewton(**NEWTON[kind],
                                             host_loop=True)))
    tm = GlowDischargeModel(GlowConfig(file_input=tree, nx=N, ny=N,
                                       dtype=tdt,
                                       newton=NewtonConfig(**NEWTON[kind],
                                                           host_loop=True)),
                            device="cpu")
    jm.system.use_gather_scatter()
    tm.system.use_gather_scatter()
    return jm, tm


def _trajectory(tree, kind):
    """(models, [(JAX state, port state as arrays)] per advance)."""
    mp = pytest.MonkeyPatch()
    # the port's line-search structure (the JAX default visits the same
    # lambda sequence)
    mp.setenv("FEDM_TPU_LS_EAGER", "1")
    try:
        jm, tm = _models(tree, kind)
        js, ts = jm.initial_state(), tm.initial_state()
        jd, td = jm.make_driver(), tm.make_driver()
        out = []
        for _ in range(N_ADVANCES):
            js = jd.advance(js, jm._update_aux_jit(js.u))
            ts = td.advance(ts, tm._update_aux(ts.u))
            out.append((js, state_to_arrays(ts)))
    finally:
        mp.undo()
    return (jm, tm), out


@pytest.fixture(scope="module")
def trajectory_f64(tree):
    return _trajectory(tree, "f64")


@pytest.fixture(scope="module")
def trajectory_f32(tree):
    return _trajectory(tree, "f32")


@pytest.mark.parametrize("kind", ["f64", "f32"])
def test_advances_follow_the_jax_trajectory(kind, request):
    _, pairs = request.getfixturevalue(f"trajectory_{kind}")
    dt_rtol, log_rtol, phi_rtol = LIMITS[kind]
    for js, ts in pairs:
        assert (ts["n_accepted"], ts["n_rejected"]) == (js.n_accepted,
                                                        js.n_rejected)
        for name in ("t", "dt", "dt_old"):
            ref = getattr(js, name)
            assert abs(ts[name] - ref) <= dt_rtol * ref, name
        for name in ("u", "u_old"):
            ref = np.asarray(getattr(js, name))
            got = ts[name]
            assert np.isfinite(got).all()
            for k in range(ref.shape[1]):
                rtol = phi_rtol if k == ref.shape[1] - 1 else log_rtol
                scale = np.abs(ref[:, k]).max()
                assert np.abs(got[:, k] - ref[:, k]).max() <= rtol * scale, \
                    (name, k)


def test_jax_checkpoint_gives_the_port_the_same_residual(trajectory_f64,
                                                         tmp_path):
    """The JAX package's state after two advances, through its checkpoint
    file, into the port: both packages' float64 residual of the next step
    at delta = 0, each with its own coefficients at the loaded state."""
    (jm, tm), pairs = trajectory_f64
    js = pairs[1][0]
    path = tmp_path / "glow.npz"
    jax_save_checkpoint(path, js, meta={"protocol": "glow-test"})
    ts, meta = load_checkpoint(path, device="cpu", with_meta=True)
    assert str(meta["protocol"]) == "glow-test"
    for name in ("u", "u_old", "u_old1"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    params = (js.t + js.dt, js.dt, js.dt_old)
    ref = np.asarray(jm.system.residual(
        js.u, js.u, js.u_old, jm._update_aux_jit(js.u),
        JaxParams(*map(jnp.asarray, params))))
    got = tm.system.residual(ts.u, ts.u, ts.u_old, StepParams(*params),
                             aux=tm._update_aux(ts.u)).numpy()
    for k in range(ref.shape[1]):
        assert np.abs(got[:, k] - ref[:, k]).max() <= \
            1e-12 * np.abs(ref[:, k]).max(), k


def test_streamer_advance_with_empty_aux_is_unchanged():
    """The streamer has no auxiliary fields: `advance(state, {})` is the
    advance it always took (`advance(state)`), bit for bit (its parity
    with the JAX package's `advance(state, {})` is held by
    test_torch_advance*.py)."""
    small = dict(z_corridor=(7e-3, 8.5e-3, 5e-5), r_corridor=(2e-3, 2e-4),
                 z_tail_cells=(12, 12), mg_levels=3, density_floor=1e13)
    newton = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=1e-4,
                          linear_maxiter=200, accept_reduction=3e-2,
                          host_loop=True)
    outs = []
    for aux in ({}, None):
        tm = StreamerModel(StreamerConfig(newton=newton,
                                          poisson_precond="mg-zline",
                                          **small),
                           device="cpu")
        tm.system.use_gather_scatter()
        ts = tm.initial_state()
        ts.dt = 1e-13
        d = tm.make_driver()
        outs.append(d.advance(ts, aux) if aux is not None else d.advance(ts))
    assert outs[0].n_accepted == outs[1].n_accepted == 1
    assert torch.equal(outs[0].u, outs[1].u) and outs[0].dt == outs[1].dt
