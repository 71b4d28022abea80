"""The host sparse-direct Newton rescue (`solvers/direct.py`), the port
against the JAX package on tests/unit/test_direct.py's small streamer
(6 x 8 graded cells, no Poisson-row preconditioner).

The counterparts of tests/unit/test_direct.py's four tests, plus parity:
- the adjacency pairs and the distance-2 colouring are the JAX arrays
  exactly (host numpy, the same algorithm);
- the probed Jacobian of the float64 model equals the JAX package's to
  1e-12 of its largest entry (measured 0: the same float64 element
  arithmetic), and equals the port's own dense Jacobian (J applied to
  every unit vector) exactly;
- a `DirectNewton.step` on the float32 model (float32 residual): the same
  iteration count, the residual norm after each iteration to 1e-6 of the
  initial norm (measured 2.4e-8: float32 residuals of float32 probes in
  another summation order; the norm after the first iteration, 1.5e-4 of
  the initial one, differs by 1.6e-4 relative), the species' increments
  to 1e-5 of their largest entry (measured 3.0e-7, 8.1e-7) and the
  potential to 5e-7 of its magnitude (measured 6.4e-8: its increment is
  4e-6 of |phi|, below float32's resolution of it);
- the escalated advance (a primary Newton too weak to converge): the same
  escalation count and accept/reject counts, t to 1e-12 (the same dt
  sequence), and the state as above.
"""

from collections import defaultdict
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JaxParams
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers import direct as jax_direct
from fedm_tpu.timestepping import AdaptiveDriver as JaxDriver
from fedm_tpu_torch.convert import state_from_arrays, state_to_arrays
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.direct import (DirectNewton,
                                           build_adjacency_pairs,
                                           greedy_distance2_coloring)
from fedm_tpu_torch.timestepping import AdaptiveDriver

SMALL = dict(nx=6, ny=8, mg_levels=0)
WEAK = dict(max_iter=1, linear_maxiter=1, rtol=1e-10, accept_reduction=0.0,
            max_stalls=1)


def _models(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.float64, torch.float64))
    jm = JaxModel(JaxConfig(dtype=jdt, **SMALL))
    tm = StreamerModel(StreamerConfig(dtype=tdt, **SMALL), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def f32_models():
    return _models("f32")


def _params(model):
    dt = model.cfg.dt_init
    return (dt, dt, 1e30)


def test_distance2_coloring_is_valid_and_the_jax_one(f32_models):
    jm, tm = f32_models
    sys_ = tm.system
    mm, nn = build_adjacency_pairs(sys_.cell_batch.dofs_np, sys_.n_dofs)
    jmm, jnn = jax_direct.build_adjacency_pairs(
        np.asarray(jm.system.cell_batch.dofs), jm.system.n_dofs)
    np.testing.assert_array_equal(mm, jmm)
    np.testing.assert_array_equal(nn, jnn)
    colors = greedy_distance2_coloring(mm, nn, sys_.n_dofs)
    np.testing.assert_array_equal(
        colors, jax_direct.greedy_distance2_coloring(jmm, jnn, sys_.n_dofs))
    assert colors.min() >= 0
    # distance 2: every row's adjacent columns have distinct colours
    cols_of_row = defaultdict(list)
    for m, n in zip(mm, nn):
        cols_of_row[m].append(colors[n])
    for m, cs in cols_of_row.items():
        assert len(cs) == len(set(cs)), f"colour collision in row {m}"
    assert colors.max() + 1 <= 16


def test_probed_jacobian_matches_dense_and_the_jax_one():
    jm, tm = _models("f64")
    rng = np.random.default_rng(0)
    s = jm.initial_state()
    delta = 0.01 * rng.standard_normal((tm.system.n_dofs, 3))
    p = _params(tm)

    dn = DirectNewton(tm.system)
    ts = state_from_arrays(s, device="cpu")
    ops = tm.system.operators(ts.u, ts.u_old1, StepParams(*p))
    J = dn.assemble(ops, torch.as_tensor(delta)).toarray()
    # the dense Jacobian column by column
    n = J.shape[0]
    jvp = ops.jacobian_action(torch.as_tensor(delta))
    eye = torch.eye(n, dtype=torch.float64)
    J_dense = np.stack([jvp(eye[i].reshape(-1, 3)).reshape(-1).numpy()
                        for i in range(n)], axis=1)
    np.testing.assert_array_equal(J, J_dense)

    jdn = jax_direct.DirectNewton(jm.system)
    jdn.prepare()
    jdn._build_jits()
    jp = JaxParams(*(jnp.asarray(x) for x in p))
    J_jax = jdn._assemble(jnp.asarray(delta), s.u, s.u_old1, {}, jp,
                          ()).toarray()
    assert np.abs(J - J_jax).max() <= 1e-12 * np.abs(J_jax).max()


def _check_state(got_u, ref_u, u0):
    """The species' increments to 1e-5 of their largest entry; the
    potential, whose float32 increment resolves only ~1e-7 of |phi|, to
    5e-7 of its magnitude."""
    for k in (0, 1):
        assert np.abs(got_u[:, k] - ref_u[:, k]).max() <= 1e-5 * np.abs(
            ref_u[:, k] - u0[:, k]).max(), k
    assert np.abs(got_u[:, 2] - ref_u[:, 2]).max() <= 5e-7 * np.abs(
        ref_u[:, 2]).max()


def test_direct_step_converges_and_matches_krylov_and_jax(f32_models):
    jm, tm = f32_models
    js = jm.initial_state()
    ts = state_from_arrays(js, device="cpu")
    p = _params(tm)
    params = StepParams(*p)
    u_krylov, info_k = tm.system.step(ts.u, ts.u, ts.u_old1, {}, params)
    dn = DirectNewton(tm.system)
    u_direct, info_d = dn.step(ts.u, ts.u, ts.u_old1, {}, params)
    assert info_d.converged and info_k.converged
    assert dn.n_factorizations >= 1
    assert dn.n_probes == dn.n_factorizations * dn.n_colors * 3
    du = (u_direct - u_krylov).abs().max().item()
    ref = (u_krylov - ts.u).abs().max().item() + 1e-12
    assert du <= 2e-2 * max(ref, 1.0), (du, ref)

    # the JAX package's DirectNewton from the same state
    jdn = jax_direct.DirectNewton(jm.system)
    norms = []
    jdn.prepare()
    jdn._build_jits()
    res = jdn._res_jit

    def recorded(*a):
        out = res(*a)
        norms.append(float(np.linalg.norm(np.asarray(out, np.float64))))
        return out

    jdn._res_jit = recorded
    jp = JaxParams(*(jnp.asarray(x) for x in p))
    ju, jinfo = jdn.step(js.u, js.u, js.u_old1, {}, jp)
    # the accepted norms: the first evaluation, then each one below the
    # norm in force (the backtracking's acceptance rule)
    history = [norms[0]]
    for f in norms[1:]:
        if np.isfinite(f) and f < history[-1]:
            history.append(f)
    assert int(jinfo.iters) == info_d.iters == jdn.n_factorizations
    assert len(dn.history) == len(history)
    gap = np.abs(np.subtract(dn.history, history)).max()
    assert gap <= 1e-6 * history[0], gap
    _check_state(u_direct.numpy(), np.asarray(ju), np.asarray(js.u))


def test_driver_escalates_to_direct_rescue_as_jax(f32_models):
    """A primary Newton too weak to converge (1 Newton, 1 Krylov iteration)
    escalates to the direct fallback at the same dt, which is accepted."""
    jm0, tm0 = f32_models
    jw = JaxModel(JaxConfig(
        dtype=jnp.float32, newton=replace(jm0.cfg.newton, **WEAK), **SMALL),
        mesh=jm0.mesh)
    tw = StreamerModel(StreamerConfig(
        dtype=torch.float32, newton=replace(tm0.cfg.newton, **WEAK),
        **SMALL), mesh=tm0.mesh, device="cpu")
    kw = dict(monitor_idx=1, ttol=tm0.cfg.ttol, dt_min=1e-16, dt_max=5e-12)
    jd = JaxDriver(jw.system, fallback_system=jax_direct.DirectNewton(
        jw.system, rtol=1e-3), **kw)
    td = AdaptiveDriver(tw.system, fallback_system=DirectNewton(
        tw.system, rtol=1e-3), **kw)
    js0 = jm0.initial_state()
    js1 = jd.advance(js0, {})
    ts1 = state_to_arrays(td.advance(state_from_arrays(js0, device="cpu")))
    assert ts1["n_accepted"] == js1.n_accepted == 1
    assert ts1["n_rejected"] == js1.n_rejected
    assert td.n_escalated == jd.n_escalated >= 1
    assert ts1["t"] > js0.t
    assert abs(ts1["t"] - js1.t) <= 1e-12 * js1.t
    _check_state(ts1["u"], np.asarray(js1.u), np.asarray(js0.u))
