"""The coupled streamer system of the port against the JAX package at one
state of the small corridor configuration (tests/unit/test_geom_mode.py):
residual, Jacobian action, node blocks and the preconditioner, in float64
to 1e-12 relative per equation, plus the float64 defect (`hi_residual`) of
the float32 system that Newton and chip_smoke.py start from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JaxParams
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.newton import NewtonConfig

SMALL = dict(z_corridor=(7e-3, 8.5e-3, 5e-5), r_corridor=(2e-3, 2e-4),
             z_tail_cells=(12, 12), mg_levels=3, density_floor=1e13)
# both packages: the structured multigrid Poisson preconditioner and the
# host-driven Newton
PRECOND = dict(poisson_precond="mg-zline")
NEWTON = dict(rtol=1e-3, max_iter=20, linear_tol=1e-4, linear_maxiter=200,
              accept_reduction=3e-2, hi_residual=True, host_loop=True)
RTOL = 1e-12
PARAMS = (1e-12, 1e-12, 2e-12)  # t, dt, dt_old


def _assert_close_per_eq(got, ref, rtol=RTOL):
    """max |got - ref| <= rtol * max |ref|, per trailing component."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    g, r = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
    for k in range(r.shape[1]):
        scale = np.abs(r[:, k]).max()
        assert np.abs(g[:, k] - r[:, k]).max() <= rtol * scale, k


def _models(jdt, tdt):
    jm = JaxModel(JaxConfig(newton=JaxNewton(**NEWTON),
                            dtype=jdt, **SMALL, **PRECOND))
    tm = StreamerModel(StreamerConfig(newton=NewtonConfig(**NEWTON),
                                      dtype=tdt, **SMALL, **PRECOND),
                       device="cpu")
    jm.system.use_gather_scatter()
    tm.system.use_gather_scatter()
    return jm, tm


def _states(space):
    """A seeded streamer-like history (u_old1, u_old) and iterate u: ion
    seed, background electrons, the charge-free potential ramp, plus noise
    (1e-3 in the log-densities, 10 V in the potential)."""
    c = space.dof_coords
    rng = np.random.default_rng(0)
    u_old1 = np.stack([
        np.log(1e13 + 5e18 * np.exp(-(c[:, 0] ** 2 + (c[:, 1] - 1e-2) ** 2)
                                    / 0.4e-3 ** 2)),
        np.full(len(c), np.log(1e13)),
        18750.0 * c[:, 1] / 0.0125], axis=-1)
    noise = np.array([1e-3, 1e-3, 10.0])
    u_old = u_old1 + noise * rng.standard_normal(u_old1.shape)
    u = u_old + noise * rng.standard_normal(u_old1.shape)
    return u, u_old, u_old1


@pytest.fixture(scope="module")
def f64():
    jm, tm = _models(jnp.float64, torch.float64)
    u, u_old, u_old1 = _states(jm.space)
    S = jm.system
    jp = JaxParams(*map(jnp.asarray, PARAMS))
    (_, u_old_c, d_hist, aux, params_c, bc_shift) = S._cast_inputs(
        jnp.asarray(u_old), jnp.asarray(u_old), jnp.asarray(u_old1), {}, jp)
    R = S.make_delta_residual_fn(u_old_c, d_hist, aux, params_c, bc_shift)
    jax_side = dict(R=R, S=S, args=(u_old_c, d_hist, aux, params_c))
    ops = tm.system.operators(torch.as_tensor(u_old), torch.as_tensor(u_old1),
                              StepParams(*PARAMS))
    return jax_side, tm, ops, u - u_old


def test_residual(f64):
    jax_side, _, ops, delta = f64
    _assert_close_per_eq(ops.residual(torch.as_tensor(delta)),
                         jax_side["R"](jnp.asarray(delta)))


def test_jacobian_action(f64):
    jax_side, _, ops, delta = f64
    v = np.random.default_rng(1).standard_normal(delta.shape)
    _, ref = jax.jvp(jax_side["R"], (jnp.asarray(delta),), (jnp.asarray(v),))
    got = ops.jacobian_action(torch.as_tensor(delta))(torch.as_tensor(v))
    _assert_close_per_eq(got, ref)


def test_node_blocks(f64):
    jax_side, _, ops, delta = f64
    ref = np.asarray(jax_side["S"]._jacobian_blocks(jnp.asarray(delta),
                                                    *jax_side["args"]))
    got = ops.jacobian_blocks(torch.as_tensor(delta)).numpy()
    # entries that are identically zero (ion rows do not see the electron
    # increment at the node) must be exactly zero in both
    zero = np.all(ref == 0, axis=0)
    assert np.all(got[:, zero] == 0)
    _assert_close_per_eq(got[:, ~zero], ref[:, ~zero])


def test_block_preconditioner(f64):
    jax_side, tm, ops, delta = f64
    r = np.random.default_rng(2).standard_normal(delta.shape)
    M = jax_side["S"].block_precond_builder(*jax_side["args"])(
        jnp.asarray(delta))
    got = tm.system.block_precond_builder(ops)(torch.as_tensor(delta))(
        torch.as_tensor(r))
    _assert_close_per_eq(got, M(jnp.asarray(r)))


def test_float64_defect_of_the_float32_system():
    """The hi residual: float64 kernel arithmetic over the float32 tables,
    here at delta = 0 as in the first Newton iterate of a step."""
    jm, tm = _models(jnp.float32, torch.float32)
    _, u_old, u_old1 = _states(jm.space)
    R = jm.system._make_hi_residual(jnp.asarray(u_old), jnp.asarray(u_old1),
                                    {}, JaxParams(*map(jnp.asarray, PARAMS)))
    ref = R(jnp.zeros(u_old.shape, jnp.float32))
    got = tm.system.residual(torch.as_tensor(u_old), torch.as_tensor(u_old),
                             torch.as_tensor(u_old1), StepParams(*PARAMS),
                             torch.float64)
    assert got.dtype == torch.float64
    _assert_close_per_eq(got, ref)
