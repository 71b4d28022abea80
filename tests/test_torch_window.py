"""The moving window of the port against the JAX package, on the
fixed-topology corridor configuration of tests/unit/test_geom_mode.py
(float32 compute, float64 defect): `move_window` moves the nodes to the
same coordinates (exactly: the same numpy arithmetic), remaps the same
state to 1e-13 of each column's magnitude (W @ U in another summation
order), and leaves a float64 residual that agrees to 1e-10 of each
equation's magnitude. After a move the system's tables and the multigrid
equal those of a model built at the new position (exactly), and K1's
compact scatter table is unchanged. `remap_state(restrict=True)` follows
the JAX package to 1e-13, and checkpoints with meta written by either
package are read by the other.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.io.checkpoint import load_checkpoint as jax_load
from fedm_tpu.io.checkpoint import save_checkpoint as jax_save
from fedm_tpu.model.system import StepParams as JaxParams
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu.timestepping.driver import TimeState as JaxState
from fedm_tpu_torch.convert import state_from_arrays, state_to_arrays
from fedm_tpu_torch.io import load_checkpoint, save_checkpoint
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.solvers.newton import NewtonConfig

SPAN, DZ = 1.5e-3, 5e-5
BASE = dict(r_corridor=(2e-3, 2e-4), z_tail_cells=(12, 12), mg_levels=3,
            density_floor=1e13, poisson_precond="mg-zline")
NEWTON = dict(rtol=1e-3, max_iter=20, linear_tol=1e-4, linear_maxiter=200,
              accept_reduction=3e-2, hi_residual=True, host_loop=True)
Z0, Z1 = 8.5e-3, 7.9e-3


def _jax(z0, **kw):
    m = JaxModel(JaxConfig(z_corridor=(z0, z0 + SPAN, DZ),
                           newton=JaxNewton(**NEWTON),
                           dtype=jnp.float32, **BASE, **kw))
    m.system.use_gather_scatter()
    m.system.enable_geom_mode()
    return m


def _port(z0, **kw):
    m = StreamerModel(StreamerConfig(z_corridor=(z0, z0 + SPAN, DZ),
                                     newton=NewtonConfig(**NEWTON),
                                     dtype=torch.float32, **BASE, **kw),
                      device="cpu")
    m.system.use_gather_scatter()
    return m


def _close_per_column(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    for k in range(ref.shape[1]):
        assert np.abs(got[:, k] - ref[:, k]).max() <= \
            rtol * np.abs(ref[:, k]).max(), k


@pytest.fixture(scope="module")
def moved():
    """Both packages' models moved from Z0 to Z1, with the JAX initial
    state at Z0 remapped by each."""
    jm, tm = _jax(Z0), _port(Z0)
    js = jm.initial_state()
    js.u_old1 = js.u_old1 * 1.0  # distinct arrays, as after a step
    ts = state_from_arrays(js, device="cpu")
    table = (tm.system.facet_kernels[0][0].scatter_rows.clone(),
             tm.system.facet_kernels[0][0].scatter_idx.clone())
    tm.batch.astype(torch.float64)  # a cached view of the old tables
    js = jm.move_window((Z1, Z1 + SPAN, DZ), js)
    ts = tm.move_window((Z1, Z1 + SPAN, DZ), ts)
    return jm, js, tm, ts, table


def test_move_window_moves_the_nodes_as_the_reference(moved):
    jm, _, tm, _, _ = moved
    np.testing.assert_array_equal(tm.mesh.coords, jm.mesh.coords)
    np.testing.assert_array_equal(tm.space.dof_coords, jm.space.dof_coords)
    assert tm.cfg.z_corridor == jm.cfg.z_corridor == (Z1, Z1 + SPAN, DZ)


def test_move_window_remaps_the_state(moved):
    _, js, _, ts, _ = moved
    got = state_to_arrays(ts)
    for name in ("u", "u_old", "u_old1"):
        _close_per_column(got[name], getattr(js, name), 1e-13)
    assert (got["t"], got["dt"], got["dt_old"]) == (js.t, js.dt, js.dt_old)


def test_residual_after_the_move(moved):
    jm, js, tm, ts, _ = moved
    p = (js.t + js.dt, js.dt, js.dt_old)
    R = jm.system._make_hi_residual(js.u, js.u_old, {},
                                    JaxParams(*map(jnp.asarray, p)))
    ref = R(jnp.zeros(js.u.shape, jnp.float32))
    got = tm.system.residual(ts.u, ts.u, ts.u_old, StepParams(*p),
                             torch.float64)
    _close_per_column(got.numpy(), ref, 1e-10)


def test_moved_system_equals_a_fresh_one(moved):
    _, _, tm, _, table = moved
    fresh = _port(Z1)
    for (b, _), (f, _) in zip(tm.system._batches(), fresh.system._batches()):
        for name in b._GEOM_FIELDS:
            assert torch.equal(getattr(b, name), getattr(f, name)), name
    for name in ("S", "wx", "wz"):
        for a, b in zip(getattr(tm._smg, name), getattr(fresh._smg, name)):
            assert torch.equal(a, b), name
    assert torch.equal(tm._smg.cinv, fresh._smg.cinv)
    # K1's compact table is a function of the facet topology alone
    fb, ffb = tm.system.facet_kernels[0][0], fresh.system.facet_kernels[0][0]
    assert torch.equal(fb.scatter_rows, table[0])
    assert torch.equal(fb.scatter_idx, table[1])
    assert torch.equal(ffb.scatter_idx, table[1])
    # the float64 view cast before the move was dropped with the old tables
    assert torch.equal(tm.batch.astype(torch.float64).grads,
                       fresh.batch.astype(torch.float64).grads)
    r = torch.randn(tm.space.n_dofs, generator=torch.Generator().manual_seed(0),
                    dtype=torch.float32)
    assert torch.equal(tm._smg.precond(r), fresh._smg.precond(r))


def test_move_window_checks_its_contract():
    tm = _port(Z0)
    fb = tm.system.facet_kernels[0][0]
    fb.scatter_idx = torch.flip(fb.scatter_idx, dims=[1]).contiguous()
    with pytest.raises(AssertionError, match="compact scatter table"):
        tm.move_window((Z1, Z1 + SPAN, DZ))
    with pytest.raises(ValueError, match="z_tail_cells"):
        StreamerModel(StreamerConfig(z_corridor=(Z0, Z0 + SPAN, DZ),
                                     r_corridor=(2e-3, 2e-4), mg_levels=3),
                      device="cpu").move_window((Z1, Z1 + SPAN, DZ))


def test_remap_state_restrict():
    """A cross-resolution remap onto a corridor of twice the dz."""
    src_kw = dict(z_corridor=(Z0, Z0 + SPAN, DZ))
    dst_kw = dict(z_corridor=(Z0, Z0 + SPAN, 2 * DZ))
    jsrc = JaxModel(JaxConfig(**src_kw, **BASE))
    jdst = JaxModel(JaxConfig(**dst_kw, **BASE))
    tsrc = StreamerModel(StreamerConfig(**src_kw, **BASE), device="cpu")
    tdst = StreamerModel(StreamerConfig(**dst_kw, **BASE), device="cpu")
    rng = np.random.default_rng(5)
    u = rng.standard_normal((jsrc.space.n_dofs, 3)) * [1.0, 2.0, 1e3] + 30.0
    arrays = dict(u=u, u_old=u * 0.5, u_old1=u * 0.25, t=1e-9, dt=1e-12,
                  dt_old=2e-12, max_error=np.ones(3), n_accepted=3,
                  n_rejected=1)
    js = JaxState(**{k: jnp.asarray(arrays[k])
                     for k in ("u", "u_old", "u_old1")})
    for restrict in (True, False):
        ref = jsrc.remap_state(jdst, js, restrict=restrict)
        got = state_to_arrays(tsrc.remap_state(
            tdst, state_from_arrays(arrays, device="cpu"),
            restrict=restrict))
        for k in ("u", "u_old", "u_old1"):
            assert got[k].shape == (tdst.space.n_dofs, 3)
            _close_per_column(got[k], getattr(ref, k), 1e-13)


def _state_arrays(seed=6):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((50, 3))
    return dict(u=u, u_old=u + 1, u_old1=u + 2, t=1.25e-9, dt=3e-12,
                dt_old=2e-12, max_error=np.array([1e-4, 2e-4, 5e-4]),
                n_accepted=11, n_rejected=4)


META = {"z_corridor": (9.1e-3, 1.06e-2, 1e-5), "z_tail_cells": (10, 48),
        "z_wall_dz": 2.5e-7, "protocol": json.dumps({"preset": "bagheri14"})}


def _check_meta(meta):
    assert tuple(float(v) for v in meta["z_corridor"]) == META["z_corridor"]
    assert tuple(int(v) for v in meta["z_tail_cells"]) == META["z_tail_cells"]
    assert float(meta["z_wall_dz"]) == META["z_wall_dz"]
    assert json.loads(str(meta["protocol"])) == {"preset": "bagheri14"}


def test_checkpoint_written_by_the_port_read_by_jax(tmp_path):
    arrays = _state_arrays()
    path = tmp_path / "checkpoint.npz"
    save_checkpoint(path, state_from_arrays(arrays, device="cpu"), meta=META)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint.npz"]
    js, meta = jax_load(path, with_meta=True)
    for k in ("u", "u_old", "u_old1"):
        np.testing.assert_array_equal(np.asarray(getattr(js, k)), arrays[k])
    assert (js.t, js.dt, js.dt_old, js.n_accepted, js.n_rejected) == (
        1.25e-9, 3e-12, 2e-12, 11, 4)
    assert list(js.max_error) == list(arrays["max_error"])
    _check_meta(meta)


def test_checkpoint_written_by_jax_read_by_the_port(tmp_path):
    arrays = _state_arrays()
    path = tmp_path / "checkpoint.npz"
    jax_save(path, JaxState(**{k: (jnp.asarray(v) if isinstance(
        v, np.ndarray) and v.ndim == 2 else v) for k, v in arrays.items()}),
        meta=META)
    ts, meta = load_checkpoint(path, device="cpu", with_meta=True)
    got = state_to_arrays(ts)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
    _check_meta(meta)
    assert load_checkpoint(path, device="cpu").n_accepted == 11
    # without meta: an empty dict
    save_checkpoint(path, ts)
    assert load_checkpoint(path, device="cpu", with_meta=True)[1] == {}
