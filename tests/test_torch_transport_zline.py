"""Transport z-line preconditioning of the electron row, the port against
the JAX package on the graded 16 x 24 streamer (float64): the
z-neighbour couplings sub and sup that the block build extracts, the
preconditioner M r with them, and one step.

Tolerances: sub and sup are float64 sums of the same element tangents in
another order (1e-12 of the largest entry; measured ~1e-16); M r 1e-12 of
each column's largest entry (measured <= 1.4e-14, the ion row's 3 x 3
block inverse); the advance the counts exactly, dt and the fields to
1e-10 relative (float64 Krylov solves in another summation order).
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

GRADED = dict(nx=16, ny=24, density_floor=1e13, transport_zline=True)


def _close(got, ref, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    for k in range(ref.shape[1]):
        scale = np.abs(ref[:, k]).max()
        assert np.abs(got[:, k] - ref[:, k]).max() <= rtol * scale, k


@pytest.fixture(scope="module", params=["mg-zline", "mg"])
def case(request):
    cfg = dict(GRADED, poisson_precond=request.param)
    jm = JaxModel(JaxConfig(**cfg))
    tm = StreamerModel(StreamerConfig(**cfg), device="cpu")
    js = jm.initial_state()
    rng = np.random.default_rng(4)
    # a state off the initial one, so the couplings are not symmetric
    u = np.asarray(js.u) + 0.3 * rng.standard_normal(js.u.shape) * [1, 1, 0]
    p = (2e-12, 1e-12, 2e-12)
    jsys = jm.system
    jp = JaxParams(*(jnp.asarray(x) for x in p))
    d0, uo, dh, ax, pc, _ = jsys._cast_inputs(jnp.asarray(u), jnp.asarray(u),
                                              js.u, {}, jp)
    ops = tm.system.operators(torch.as_tensor(u), torch.as_tensor(
        np.asarray(js.u)), StepParams(*p))
    return jm, tm, jsys, (d0, uo, dh, ax, pc), ops


def test_sub_and_sup(case):
    _, tm, jsys, args, ops = case
    jb, (jsub, jsup) = jsys._jacobian_blocks_zline(*args)
    eqs, _, m_sub, m_sup = tm.system._tzline
    blocks, (sub, sup) = ops.jacobian_blocks(
        torch.zeros((tm.system.n_dofs, 3), dtype=torch.float64),
        (eqs, m_sub, m_sup))
    assert eqs == (1,) and float(np.abs(np.asarray(jsub)).max()) > 0
    _close(sub, jsub, 1e-12)
    _close(sup, jsup, 1e-12)
    _close(blocks.reshape(-1, 9), np.asarray(jb).reshape(-1, 9), 1e-12)


def test_preconditioner(case):
    _, tm, jsys, args, ops = case
    M = jsys.block_precond_builder(*args[1:])(args[0])
    delta = torch.zeros((tm.system.n_dofs, 3), dtype=torch.float64)
    Mt = tm.system.block_precond_builder(ops)(delta)
    r = np.random.default_rng(5).standard_normal((tm.system.n_dofs, 3))
    _close(Mt(torch.as_tensor(r)), M(jnp.asarray(r)), 1e-12)


def test_one_step():
    cfg = dict(GRADED, poisson_precond="mg-zline")
    jm = JaxModel(JaxConfig(**cfg))
    tm = StreamerModel(StreamerConfig(**cfg), device="cpu")
    js = jm.initial_state()
    js.dt = 1e-12
    ts = state_from_arrays(js, device="cpu")
    js = jm.make_driver().advance(js, {})
    got = state_to_arrays(tm.make_driver().advance(ts))
    assert (got["n_accepted"], got["n_rejected"]) == (js.n_accepted,
                                                      js.n_rejected)
    assert abs(got["dt"] - js.dt) <= 1e-10 * js.dt
    _close(got["u"], js.u, 1e-10)
