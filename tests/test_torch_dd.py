"""The port's DOF-partitioned domain decomposition (`parallel.dd`, N parts
stacked on one device) against the JAX package's on the CPU, the cases of
`tests/parallel/test_dd.py`:

- the layout tables (n_own_max, n_ghost_max, `_slot_of`, `_dist_src`, the
  ring shifts and their send/recv/mask tables, `mask_dist`, every per-part
  element array) equal to those of the JAX `DistributedSystem` (its host
  tables only: no shard_map is compiled) for the streamer 12 x 16 in 8
  parts, 7 x 9 in 4 and the glow 10 x 10 in 8;
- the round trip exact, phantom rows exactly 0;
- the residual, the node blocks and `_dist_stiffness_op` against the JAX
  package's single-device system, at rtol 1e-10 and atol 1e-12 times the
  largest entry (the JAX test's tolerances: the parts' sums run in another
  order);
- a full step, the distributed-elliptic step and the glow full step (aux
  fields, facet kernels) against the JAX single-device step at rtol 1e-6,
  atol 1e-10 (the JAX test's: Newton stops at rtol 1e-4 and two summation
  orders take slightly other iterates);
- two driver advances;
- controls: the residual with the reverse exchange skipped, or with either
  exchange's roll direction flipped, fails the residual tolerance;
- distinct devices raise.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JParams
from fedm_tpu.models.argon_synth import generate_argon_input as jax_generate
from fedm_tpu.models.glow import GlowConfig as JGlowConfig
from fedm_tpu.models.glow import GlowDischargeModel as JGlow
from fedm_tpu.models.streamer import StreamerConfig as JConfig
from fedm_tpu.models.streamer import StreamerModel as JStreamer
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.glow import GlowConfig, GlowDischargeModel
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.parallel import DistributedSystem

PARAMS = (5e-12, 5e-12, 1e30)
GLOW_PARAMS = (1e-13, 1e-13, 1e30)
OPS_RTOL, OPS_ATOL_REL = 1e-10, 1e-12
STEP_RTOL, STEP_ATOL = 1e-6, 1e-10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("space",))


def _jparams(p):
    return JParams(*(jnp.asarray(x) for x in p))


def _close_ops(got, ref):
    np.testing.assert_allclose(got, ref, rtol=OPS_RTOL,
                               atol=OPS_ATOL_REL * np.abs(ref).max())


@pytest.fixture(scope="module")
def argon_tree(tmp_path_factory):
    base = tmp_path_factory.mktemp("argon")
    jax_generate(base)
    return base


def _streamers(nx, ny, n):
    jd = JStreamer(JConfig(nx=nx, ny=ny)).distribute(_jmesh(n))
    ref = StreamerModel(StreamerConfig(nx=nx, ny=ny), device="cpu")
    dm = StreamerModel(StreamerConfig(nx=nx, ny=ny), device="cpu")
    return jd, ref, dm, dm.distribute(["cpu"] * n)


@pytest.fixture(scope="module")
def streamer():
    """(JAX single-device model, JAX dd, port model, port dd model, port
    dd) for the 12 x 16 streamer in 8 parts."""
    jm = JStreamer(JConfig(nx=12, ny=16))
    jd, ref, dm, d = _streamers(12, 16, 8)
    return jm, jd, ref, dm, d


@pytest.fixture(scope="module")
def glow(argon_tree):
    cfg = dict(file_input=argon_tree, nx=10, ny=10, ttol=2e-3, mg_levels=0)
    jm = JGlow(JGlowConfig(**cfg))
    jd = JGlow(JGlowConfig(**cfg)).distribute(_jmesh(8))
    ref = GlowDischargeModel(GlowConfig(**cfg), device="cpu")
    dm = GlowDischargeModel(GlowConfig(**cfg), device="cpu")
    return jm, jd, ref, dm, dm.distribute(["cpu"] * 8)


def _layout_equal(jd, d):
    assert (d.n_own_max, d.n_ghost_max, d.n_ext, d.n_dofs_dist) == (
        jd.n_own_max, jd.n_ghost_max, jd.n_ext, jd.n_dofs_dist)
    np.testing.assert_array_equal(d._slot_of, jd._slot_of)
    np.testing.assert_array_equal(d._dist_src, jd._dist_src)
    np.testing.assert_array_equal(d.mask_dist.numpy(),
                                  np.asarray(jd.mask_dist))
    N = d.n_parts
    assert len(d._shifts) == len(jd._shifts)
    for k, (dd, (perm_fwd, perm_rev)) in enumerate(zip(d._shifts,
                                                       jd._shifts)):
        assert perm_fwd == [(i, (i + dd) % N) for i in range(N)]
        assert perm_rev == [(i, (i - dd) % N) for i in range(N)]
        for got, ref in zip(d._shift_np[k], jd._shift_arrays[3 * k:3 * k + 3]):
            np.testing.assert_array_equal(got, np.asarray(ref))
    # the per-part element arrays: the stacked batches hold the JAX
    # package's per-part arrays, each part's dofs offset by p * n_ext
    i = 0
    assert len(d._batches) == len(jd._batch_meta)
    src = list(d.inner._batches())
    for k, ((tb, _), (tmpl, _, n_arr)) in enumerate(zip(d._batches,
                                                        jd._batch_meta)):
        fields = type(tmpl)._SHARD_FIELDS
        assert fields == tb._SHARD_FIELDS
        for f, ref in zip(fields, jd._batch_arrays[i:i + n_arr]):
            ref = np.asarray(ref)
            if f == "dofs":
                offset = (np.arange(len(ref)) // (len(ref) // N)) * d.n_ext
                np.testing.assert_array_equal(tb.dofs_np - offset[:, None],
                                              ref)
            else:
                np.testing.assert_array_equal(getattr(tb, f).numpy(), ref)
        i += n_arr
        assert tuple(tb.gather_idx.shape)[0] == N * d.n_ext
        assert tb._structured is None
        # every batch scatters over its live rows (the trash rows never
        # are), and its padded elements have no slot
        assert tb.scatter_rows is not None
        n_real = src[k][0].dofs.numel()
        assert int((tb.gather_idx < tb.dofs.numel()).sum()) == n_real
        assert int((tb.scatter_idx < tb.dofs.numel()).sum()) == n_real


def test_layout_streamer_8_parts(streamer):
    _, jd, _, _, d = streamer
    _layout_equal(jd, d)
    assert set(d._shifts) <= {1, 7}


def test_layout_odd_sizes_4_parts():
    jd, _, _, d = _streamers(7, 9, 4)
    _layout_equal(jd, d)


def test_layout_glow_8_parts(glow):
    _layout_equal(glow[1], glow[4])


def test_round_trip_and_phantoms(streamer):
    _, _, ref, dm, d = streamer
    u0 = ref.initial_state().u.numpy()
    ud = d.to_dist(u0)
    assert ud.shape == (8 * d.n_own_max, 3)
    np.testing.assert_array_equal(d.from_dist(ud), u0)
    np.testing.assert_array_equal(d.from_dist(dm.initial_state().u), u0)
    phantom = np.setdiff1d(np.arange(d.n_dofs_dist), d._slot_of)
    assert len(phantom) and not ud[phantom].any()
    np.testing.assert_array_equal(d.gather_global(ud).numpy(), u0)
    aux = d.scatter_aux({"f": torch.as_tensor(u0[:, 0]), "k": 3.0})
    assert aux["k"] == 3.0
    np.testing.assert_array_equal(d.from_dist(aux["f"]), u0[:, 0])


def _residual_and_blocks(jm, dm, d, params, aux_of=None):
    """(JAX F, JAX B, port dd F, port dd B) at each package's initial
    state."""
    js = jm.initial_state()
    jaux = {} if aux_of is None else jm._update_aux_jit(js.u)
    jp = _jparams(params)
    F_ref = np.asarray(jm.system.residual(js.u, js.u, js.u_old1, jaux, jp))
    B_ref = np.asarray(jm.system._jacobian_blocks(
        jnp.zeros_like(js.u), js.u, js.u - js.u_old1, jaux, jp))
    s = dm.initial_state()
    aux = {} if aux_of is None else dm._update_aux(s.u)
    p = StepParams(*params)
    F = d.from_dist(d.residual(s.u, s.u, s.u_old1, p, aux=aux))
    B = d.from_dist(d.operators(s.u, s.u_old1, p, aux=aux).jacobian_blocks(
        torch.zeros_like(s.u)))
    return F_ref, B_ref, F, B


def test_residual_and_blocks_match_the_jax_single_device(streamer):
    jm, _, _, dm, d = streamer
    F_ref, B_ref, F, B = _residual_and_blocks(jm, dm, d, PARAMS)
    _close_ops(F, F_ref)
    _close_ops(B, B_ref)


def test_residual_odd_sizes_4_parts():
    _, _, dm, d = _streamers(7, 9, 4)
    jm = JStreamer(JConfig(nx=7, ny=9))
    js = jm.initial_state()
    F_ref = np.asarray(jm.system.residual(js.u, js.u, js.u, {},
                                          _jparams(PARAMS)))
    s = dm.initial_state()
    _close_ops(d.from_dist(d.residual(s.u, s.u, s.u, StepParams(*PARAMS))),
               F_ref)


def test_glow_residual_and_blocks_with_aux(glow):
    jm, _, _, dm, d = glow
    F_ref, B_ref, F, B = _residual_and_blocks(jm, dm, d, GLOW_PARAMS,
                                              aux_of=True)
    _close_ops(F, F_ref)
    _close_ops(B, B_ref)


def test_phantom_rows_stay_zero(streamer):
    _, _, _, dm, d = streamer
    s = dm.initial_state()
    p = StepParams(*PARAMS)
    phantom = torch.as_tensor(np.setdiff1d(np.arange(d.n_dofs_dist),
                                           d._slot_of))
    ops = d.operators(s.u, s.u, p)
    z = torch.zeros_like(s.u)
    assert not ops.residual(z)[phantom].any()
    v = torch.randn(s.u.shape, dtype=s.u.dtype,
                    generator=torch.Generator().manual_seed(1))
    v[phantom] = 0.0
    assert not ops.jacobian_action(z)(v)[phantom].any()
    B = ops.jacobian_blocks(z)[phantom]
    assert torch.equal(B, torch.eye(3, dtype=B.dtype).expand_as(B))


def test_distributed_stiffness_op_matches(streamer):
    jm, _, _, _, d = streamer
    A_ref = jm.system.masked_stiffness_op(2)
    x = np.random.default_rng(3).standard_normal(jm.system.n_dofs)
    y_ref = np.asarray(A_ref(jnp.asarray(x)))
    y = d.from_dist(d._dist_stiffness_op(2)(d.to_dist(torch.as_tensor(x))))
    _close_ops(y, y_ref)


@pytest.fixture(scope="module")
def jax_step(streamer):
    jm = streamer[0]
    js = jm.initial_state()
    u1, info = jm.system.step(js.u, js.u, js.u, {}, _jparams(PARAMS))
    assert bool(info.converged)
    return np.asarray(u1)


def test_full_step_matches_the_jax_single_device(streamer, jax_step):
    _, _, _, dm, d = streamer
    s = dm.initial_state()
    u2, info = d.step(s.u, s.u, s.u, {}, StepParams(*PARAMS))
    assert info.converged
    np.testing.assert_allclose(d.from_dist(u2), jax_step, rtol=STEP_RTOL,
                               atol=STEP_ATOL)


def test_distributed_elliptic_step(streamer, jax_step):
    _, _, dm, d = _streamers(12, 16, 8)
    d.enable_distributed_elliptic(2, degree=10)
    assert d._dist_ell is not None
    s = dm.initial_state()
    u2, info = d.step(s.u, s.u, s.u, {}, StepParams(*PARAMS))
    assert info.converged
    np.testing.assert_allclose(d.from_dist(u2), jax_step, rtol=STEP_RTOL,
                               atol=STEP_ATOL)


def test_glow_full_step_matches_the_jax_single_device(glow):
    jm, _, _, dm, d = glow
    js = jm.initial_state()
    u1, info1 = jm.system.step(js.u, js.u, jnp.zeros_like(js.u),
                               jm._update_aux_jit(js.u),
                               _jparams(GLOW_PARAMS))
    assert bool(info1.converged)
    s = dm.initial_state()
    u2, info2 = d.step(s.u, s.u, torch.zeros_like(s.u), dm._update_aux(s.u),
                       StepParams(*GLOW_PARAMS))
    assert info2.converged
    np.testing.assert_allclose(d.from_dist(u2), np.asarray(u1),
                               rtol=STEP_RTOL, atol=STEP_ATOL)


def test_two_driver_advances(streamer):
    _, _, _, dm, d = streamer
    driver = dm.make_driver()
    st = dm.initial_state()
    st = driver.advance(st, {})
    st = driver.advance(st, {})
    assert st.n_accepted == 2 and st.t > 0
    u = d.from_dist(st.u)
    assert np.isfinite(u).all()
    phantom = np.setdiff1d(np.arange(d.n_dofs_dist), d._slot_of)
    assert not st.u[phantom].any()


def _flipped(d, which):
    """A copy of the halo exchange with one direction broken."""
    fill, reduce = d._halo_fill, d._halo_reduce
    if which == "no reverse exchange":
        def reduce_(r_ext):
            tr = tuple(r_ext.shape[1:])
            return r_ext.reshape((d.n_parts, d.n_ext) + tr)[
                :, :d.n_own_max].reshape((d.n_dofs_dist,) + tr)
        return fill, reduce_
    flipped = DistributedSystem.__new__(DistributedSystem)
    flipped.__dict__.update(d.__dict__)
    flipped._shifts = [-s for s in d._shifts]
    if which == "fill rolled the other way":
        return flipped._halo_fill, reduce
    return fill, flipped._halo_reduce


@pytest.mark.parametrize("which", ["no reverse exchange",
                                   "fill rolled the other way",
                                   "reduce rolled the other way"])
def test_a_broken_halo_exchange_fails_the_tolerance(streamer, which):
    jm, _, _, dm, d = streamer
    js = jm.initial_state()
    F_ref = np.asarray(jm.system.residual(js.u, js.u, js.u, {},
                                          _jparams(PARAMS)))
    s = dm.initial_state()
    fill, reduce = _flipped(d, which)
    with mock.patch.object(d, "_halo_fill", fill), \
            mock.patch.object(d, "_halo_reduce", reduce):
        F = d.from_dist(d.residual(s.u, s.u, s.u, StepParams(*PARAMS)))
    F_ok = d.from_dist(d.residual(s.u, s.u, s.u, StepParams(*PARAMS)))
    _close_ops(F_ok, F_ref)
    with pytest.raises(AssertionError):
        _close_ops(F, F_ref)


def test_distinct_devices_raise():
    m = StreamerModel(StreamerConfig(nx=4, ny=6), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        m.distribute(["cpu", "meta"])
    with pytest.raises(ValueError):
        m.distribute(["meta", "meta"])
    with pytest.raises(ValueError):
        m.distribute([])


def _forward_mode_per_product(glow, which, dtype):
    """The glow's operators in `dtype` at a seeded delta, and beside them a
    seeded v, J(delta) v and the node blocks from forward-mode passes
    through the element kernels: one per product, one per local basis
    vector."""
    import torch.autograd.forward_ad as fwAD

    def tangent(batch, kernel, ctx, u_e, t_e):
        with fwAD.dual_level():
            out = kernel(batch, fwAD.make_dual(u_e, t_e), ctx)
            return fwAD.unpack_dual(out).tangent

    _, _, ref, dm, d = glow
    model, sys_ = (ref, ref.system) if which == "undistributed" else (dm, d)
    s = model.initial_state()
    aux = model._update_aux(s.u)
    p = StepParams(*GLOW_PARAMS)
    delta = torch.as_tensor(np.random.default_rng(2).standard_normal(
        tuple(s.u.shape)) * 1e-3).to(dtype)
    v = torch.as_tensor(np.random.default_rng(3).standard_normal(
        tuple(s.u.shape))).to(dtype)
    ops = sys_.operators(s.u, s.u_old1, p, dtype, aux=aux)
    d_in, v_in = ops._in(delta), ops._in(v)
    out = ops._zeros(ops.n_eq)
    blocks = ops._zeros(ops.n_eq, ops.n_eq)
    for (batch, kernel), ctx in zip(ops.batches, ops.ctxs):
        u_e = batch.gather(d_in)
        out = batch.scatter_add(out, tangent(batch, kernel, ctx, u_e,
                                             batch.gather(v_in)))
        diag = torch.empty(u_e.shape + (ops.n_eq,), dtype=u_e.dtype)
        for a in range(u_e.shape[1]):
            for j in range(ops.n_eq):
                e = torch.zeros_like(u_e)
                e[:, a, j] = 1.0
                diag[:, a, :, j] = tangent(batch, kernel, ctx, u_e, e)[:, a]
        blocks = batch.scatter_add(blocks, diag)
    J0 = torch.where(ops.mask, v, ops._out(out))
    B0 = torch.where(ops.mask[:, :, None], torch.eye(ops.n_eq, dtype=dtype),
                     ops._out(blocks))
    return ops, delta, v, J0, B0


@pytest.mark.parametrize("which", ["undistributed", "8 parts"])
def test_element_jacobian_matches_a_forward_mode_pass_per_product(glow,
                                                                   which):
    """In float64, J v from the element Jacobians (one batched forward-mode
    pass per iterate) against a forward-mode pass through the element
    kernels per product, on the glow: to 1e-13 of its largest entry (the
    same products summed in another order), and the node blocks equal
    those of a pass per local basis vector."""
    ops, delta, v, J0, B0 = _forward_mode_per_product(glow, which,
                                                      torch.float64)
    assert ops.element_jacobian
    J1 = ops.jacobian_action(delta)(v)
    assert float((J1 - J0).abs().max()) <= 1e-13 * float(J0.abs().max())
    assert torch.equal(ops.jacobian_blocks(delta), B0)


@pytest.mark.parametrize("which", ["undistributed", "8 parts"])
def test_float32_jacobian_action_is_a_forward_mode_pass_per_product(glow,
                                                                    which):
    """In float32, J v is a forward-mode pass per product and the node
    blocks one per basis vector, as the JAX package computes them: equal
    to those passes bit for bit."""
    ops, delta, v, J0, B0 = _forward_mode_per_product(glow, which,
                                                      torch.float32)
    assert not ops.element_jacobian
    assert torch.equal(ops.jacobian_action(delta)(v), J0)
    assert torch.equal(ops.jacobian_blocks(delta), B0)
