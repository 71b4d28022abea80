"""The compact form of the ELL gather-sum (K1) on the CPU: the table
compacted to the live dofs against the dense one and the JAX package's,
`ell_scatter_add_`'s plain version against the Pallas kernel in interpret
mode, and the port's `scatter_add` against the JAX package's
`out + scatter` on the small streamer mesh's electrode facets. The CUDA
kernel itself is held to the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.ops.pallas_scatter import pallas_ell_scatter
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu_torch.fem.assembly import (build_ell_index,
                                         build_ell_index_compact)
from fedm_tpu_torch.model.system import StepParams
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
from fedm_tpu_torch.ops.ell_scatter import (ell_scatter_add_,
                                            ell_scatter_add_ref,
                                            ell_scatter_ref, launch_count)

SMALL = dict(z_corridor=(7e-3, 8.5e-3, 5e-5), r_corridor=(2e-3, 2e-4),
             z_tail_cells=(12, 12), mg_levels=3, density_floor=1e13)
# both packages: the structured multigrid Poisson preconditioner
PRECOND = dict(poisson_precond="mg-zline")
RTOL = {torch.float64: 1e-14, torch.float32: 1e-6}


def _random_dofs(seed, n_dofs=60, max_val=8):
    """Element dofs [n_elems, 3] in which every live dof has a valence
    drawn from 1..max_val and about a third of the dofs receive nothing."""
    rng = np.random.default_rng(seed)
    live = rng.permutation(n_dofs)[: 2 * n_dofs // 3]
    val = rng.integers(1, max_val + 1, live.size)
    val[:max_val] = np.arange(1, max_val + 1)  # every valence occurs
    val[max_val] = 1  # takes the padding to a whole number of elements
    flat = np.repeat(live, val)
    flat = np.concatenate([flat, np.repeat(live[max_val], -flat.size % 3)])
    return rng.permutation(flat).reshape(-1, 3)


@pytest.mark.parametrize("seed", range(4))
def test_compact_table_is_the_dense_table_at_its_live_rows(seed):
    n_dofs = 60
    dofs = _random_dofs(seed, n_dofs)
    dense = build_ell_index(dofs, n_dofs)
    rows, idx = build_ell_index_compact(dofs, n_dofs)
    assert rows.dtype == idx.dtype == np.int32
    np.testing.assert_array_equal(rows, np.unique(dofs))
    assert np.all(np.diff(rows) > 0)
    assert idx.shape == (rows.size, dense.shape[1])
    np.testing.assert_array_equal(idx, dense[rows])
    # the rows left out receive nothing: only the sentinel
    dead = np.setdiff1d(np.arange(n_dofs), rows)
    assert dead.size and np.all(dense[dead] == dofs.size)
    valence = np.bincount(dofs.ravel(), minlength=n_dofs)
    assert set(range(1, 9)) <= set(valence[rows]) and dense.shape[1] == 8


@pytest.mark.parametrize("C", [1, 3])
def test_plain_version_matches_out_plus_pallas_interpret(C):
    rng = np.random.default_rng(C)
    n_dofs = 60
    dofs = _random_dofs(10 + C, n_dofs)
    rows, idx = build_ell_index_compact(dofs, n_dofs)
    dense = build_ell_index(dofs, n_dofs)
    flat = rng.standard_normal((dofs.size, C))
    out0 = rng.standard_normal((n_dofs, C))
    got = ell_scatter_add_ref(torch.as_tensor(out0, dtype=torch.float32),
                              torch.as_tensor(flat, dtype=torch.float32),
                              torch.as_tensor(idx),
                              torch.as_tensor(rows)).numpy()
    # the Pallas kernel takes one trailing component per call over the
    # dense table, with the sentinel zero row appended
    for c in range(C):
        ref = out0[:, c].astype(np.float32) + np.asarray(pallas_ell_scatter(
            jnp.asarray(np.append(flat[:, c], 0.0), jnp.float32),
            jnp.asarray(dense), tile=32, interpret=True))
        np.testing.assert_allclose(got[:, c], ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("trailing", [(), (3,), (3, 3)])
def test_cpu_tensors_take_the_plain_version_in_place(trailing):
    rng = np.random.default_rng(3)
    dofs = _random_dofs(3)
    rows, idx = map(torch.as_tensor, build_ell_index_compact(dofs, 60))
    flat = torch.as_tensor(rng.standard_normal((dofs.size,) + trailing))
    out = torch.as_tensor(rng.standard_normal((60,) + trailing))
    before = launch_count("ell_scatter_add_")
    flat0, out0 = flat.clone(), out.clone()
    got = ell_scatter_add_(out, flat, idx, rows)
    assert launch_count("ell_scatter_add_") == before  # no kernel on the CPU
    assert got is out and torch.equal(flat, flat0)
    ref = out0.clone()
    ref.index_add_(0, torch.as_tensor(dofs.reshape(-1)), flat)
    torch.testing.assert_close(out, ref, rtol=1e-14, atol=1e-14)
    dead = np.setdiff1d(np.arange(60), rows.numpy())
    assert torch.equal(out[dead], out0[dead])


def test_rows_none_adds_to_every_row():
    rng = np.random.default_rng(4)
    idx = torch.as_tensor(rng.integers(0, 30, (20, 3)), dtype=torch.int32)
    flat = torch.as_tensor(rng.standard_normal((25, 2)))
    out = torch.as_tensor(rng.standard_normal((20, 2)))
    ref = out + ell_scatter_ref(flat, idx)
    torch.testing.assert_close(ell_scatter_add_(out, flat, idx), ref,
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["table", "rows", "rows-none", "trailing",
                                  "dtype", "grad"])
def test_rejects_what_it_does_not_take(case):
    idx = torch.zeros((4, 2), dtype=torch.int32)
    rows = torch.arange(4, dtype=torch.int32)
    flat, out = torch.zeros(6, 3), torch.zeros(10, 3)
    args = {"table": (out, flat, idx[0], rows),
            "rows": (out, flat, idx, rows[:3]),
            "rows-none": (out, flat, idx, None),
            "trailing": (torch.zeros(10, 2), flat, idx, rows),
            "dtype": (out.double(), flat, idx, rows),
            "grad": (out.requires_grad_(), flat, idx, rows)}[case]
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        ell_scatter_add_(*args)


# -- the electrode facets of the small streamer mesh --------------------------

@pytest.fixture(scope="module")
def models():
    pairs = {}
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        jm = JaxModel(JaxConfig(newton=JaxNewton(), dtype=jdt, **SMALL,
                                **PRECOND))
        tm = StreamerModel(StreamerConfig(dtype=tdt, **SMALL, **PRECOND),
                           device="cpu")
        jm.system.use_gather_scatter()
        tm.system.use_gather_scatter()
        pairs[tdt] = jm, tm
    return pairs


def test_facet_tables_match_the_jax_table_at_the_live_rows(models):
    jm, tm = models[torch.float64]
    jf, tf = jm.system.facet_kernels[0][0], tm.system.facet_kernels[0][0]
    rows = tf.scatter_rows.numpy()
    np.testing.assert_array_equal(rows, np.unique(np.asarray(jf.dofs)))
    assert 0 < rows.size < tf.n_dofs
    np.testing.assert_array_equal(tf.scatter_idx.numpy(),
                                  np.asarray(jf.gather_idx)[0][rows])
    assert tf.scatter_idx.is_contiguous()


@pytest.mark.parametrize("trailing", [(3,), (3, 3)], ids=["n_eq", "blocks"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("which", ["facet", "cell"])
def test_scatter_add_matches_jax_out_plus_scatter(models, which, dtype,
                                                  trailing):
    jm, tm = models[dtype]
    if which == "facet":
        jb, tb = jm.system.facet_kernels[0][0], tm.system.facet_kernels[0][0]
    else:  # the structured branch: out += scatter
        jb, tb = jm.batch, tm.batch
    rng = np.random.default_rng(5)
    n_elems = tb.dofs.shape[0]
    c = rng.standard_normal((n_elems, 3) + trailing)
    out0 = rng.standard_normal((tb.n_dofs,) + trailing)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = np.asarray(jnp.asarray(out0, jdt) + jb.scatter(jnp.asarray(c, jdt)))
    contrib = torch.as_tensor(c, dtype=dtype)
    out = torch.tensor(out0, dtype=dtype)
    got = tb.scatter_add(out, contrib)
    assert got is out  # in place on both branches
    assert got.dtype == dtype
    assert torch.equal(contrib, torch.as_tensor(c, dtype=dtype))  # untouched
    g, r = got.numpy().reshape(tb.n_dofs, -1), ref.reshape(tb.n_dofs, -1)
    for k in range(r.shape[1]):
        scale = np.abs(r[:, k]).max()
        assert np.abs(g[:, k] - r[:, k]).max() <= RTOL[dtype] * scale, k


def test_residual_and_operators_repeat_exactly(models):
    _, tm = models[torch.float32]
    c = tm.space.dof_coords
    rng = np.random.default_rng(6)
    u_old = np.stack([np.full(len(c), np.log(1e13)),
                      np.full(len(c), np.log(1e13)),
                      18750.0 * c[:, 1] / 0.0125], axis=-1)
    u_old = torch.as_tensor(u_old + rng.standard_normal(u_old.shape)
                            * [1e-3, 1e-3, 10.0])
    ops = tm.system.operators(u_old, u_old, StepParams(1e-12, 1e-12, 2e-12))
    delta = torch.as_tensor(rng.standard_normal(u_old.shape) * 1e-3,
                            dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal(u_old.shape), dtype=torch.float32)
    delta0 = delta.clone()
    assert torch.equal(ops.residual(delta), ops.residual(delta))
    Jv = ops.jacobian_action(delta)
    assert torch.equal(Jv(v), Jv(v))
    assert torch.equal(ops.jacobian_blocks(delta),
                       ops.jacobian_blocks(delta))
    assert torch.equal(delta, delta0)
