"""The structured streamer on z-slabs (`CoupledSystem.use_gspmd`,
`fedm_tpu_torch.parallel.slabs`), one gloo rank per slab, against the
one-process port and against the JAX package's GSPMD path
(`tests/parallel/test_gspmd_*.py`):

- the aligned partition: odd node counts split at the coarsest level's
  cell rows, refused where those are fewer than the ranks;
- on 2 and 3 ranks, bit for bit against one process: the state's halo
  fill, the stencil matvec with halo rows, the z-line (PCR) solve, the
  restriction and prolongation along z (a seeded 17 x 57 grid, 3
  levels), and on the miniature production model of
  `tests/parallel/test_gspmd_production.py` (float32 with the float64
  defect, mg-zline with 3 levels, 33 x 57 nodes) the residual, the
  float64 defect, J v, the node blocks, one V-cycle, one z-line solve and
  one whole preconditioner application; a residual whose halo exchange
  drops the row from below must differ;
- the 16 x 16 model of `tests/parallel/test_gspmd_structured.py`
  (`poisson_precond="zline"`, float64): one step on 2 ranks from the JAX
  package's initial state against the JAX package's live `use_gspmd` over
  2 virtual CPU devices, at that test's tolerance;
- the miniature production protocol (an advance, a window move, an
  advance) on 2 ranks against the one-process port, live, at
  `test_gspmd_production.py`'s rtol 5e-5, atol 1e-7 with equal counts;
  and against the JAX package's `use_gspmd` numbers of the same protocol
  on 8 virtual devices, pinned below from
  `JAX_PLATFORMS=cpu python tools/port_reference_gspmd.py`: equal counts,
  t and dt within 5e-6 relative, column norms within 5e-5.

The einsum exception of the card runs (the cells' einsums rounding by
the cell count) does not arise on the CPU: every comparison here is bit
for bit. Also on the CPU: the slab pieces on ranks that are threads of one
process (`slab_probe.emulate`, the card's diagnosis), the per-column hold
of the card's einsum exception (`slab_probe.judge`) against its controls,
and the march on one slab of a one-rank group bit for bit with one
process.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JParams
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu_torch.convert import join_state, split_state
from fedm_tpu_torch.parallel import rank_checks, ranks
from fedm_tpu_torch.parallel.slab_probe import anchor_of, emulate, judge
from fedm_tpu_torch.parallel.slabs import SlabLayout

LAUNCH_S = 300
SPAN, DZ = 1.5e-3, 5e-5
MOVE_TO = (6.0e-3, 6.0e-3 + SPAN, DZ)
MINI = {"cfg": dict(z_corridor=(8.5e-3, 8.5e-3 + SPAN, DZ),
                    r_corridor=(2e-3, 2e-4), z_tail_cells=(12, 12),
                    mg_levels=3, poisson_precond="mg-zline",
                    density_floor=1e13),
        "newton": dict(rtol=1e-3, max_iter=20, linear_tol=1e-4,
                       linear_maxiter=200, accept_reduction=3e-2,
                       host_loop=True, hi_residual=True),
        "float32": True}
MARCH = {**MINI, "plan": ["advance", ("move", MOVE_TO), "advance"]}
UNITS = {"n_i": 17, "n_j": 57, "levels": 3}
ZLINE16 = dict(nx=15, ny=15, mg_levels=0, poisson_precond="zline")
STEP = (5e-12, 5e-12, 1e30)
OPS = ("F", "F64", "Jv", "B", "V", "zline", "M")
# tools/port_reference_gspmd.py (JAX use_gspmd on 8 virtual CPU devices):
# per advance n_accepted, n_rejected, t, dt and the column 2-norms of u
JAX_GSPMD = [
    {"n_accepted": 1, "n_rejected": 0, "t": 5e-12, "dt": 5e-12,
     "col_norms": [1346.128502113016, 1298.3353177411732,
                   627596.5476909904]},
    {"n_accepted": 2, "n_rejected": 0, "t": 1e-11, "dt": 5e-12,
     "col_norms": [1303.1664272010662, 1298.2503779396548,
                   464206.1702613592]}]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} JAX devices")
    return Mesh(np.array(devs[:n]), ("space",))


@pytest.fixture(scope="module")
def jax_zline16():
    """The JAX 16 x 16 zline model's initial state and one step under its
    live `use_gspmd` on 2 virtual devices."""
    m = JaxModel(JaxConfig(**ZLINE16))
    m.system.use_gather_scatter()
    st = m.initial_state()
    m.system.use_gspmd(_jax_mesh(2))
    u2, info = m.system.step(st.u, st.u, st.u, {},
                             JParams(*(jnp.asarray(x) for x in STEP)))
    assert bool(info.converged)
    return np.asarray(st.u), np.asarray(u2)


@pytest.fixture(scope="module")
def two_ranks(jax_zline16):
    u0 = jax_zline16[0]
    zl = {"cfg": ZLINE16, "u": {"u": u0, "u_old": u0, "u_old1": u0,
                                "t": 0.0, "dt": STEP[1], "dt_old": 1e30},
          "plan": [("step", STEP)]}
    # then the one-process march (rank 0) and the same on one slab of a
    # one-rank group (rank 1), side by side
    return ranks.launch(rank_checks.several, 2, "cpu", (
        [("units", "slab_units", UNITS), ("ops", "slab_ops", MINI),
         ("march", "slab_march", MARCH), ("zline16", "slab_march", zl),
         ("plain_march", "on_one_rank",
          {"rank": 0, "worker": "slab_march", "spec": MARCH}),
         ("march1", "on_one_rank",
          {"rank": 1, "worker": "slab_march_one_rank", "spec": MARCH})],),
        timeout=LAUNCH_S)


@pytest.fixture(scope="module")
def three_ranks():
    return ranks.launch(rank_checks.several, 3, "cpu", (
        [("units", "slab_units", UNITS), ("ops", "slab_ops", MINI)],),
        timeout=LAUNCH_S)


@pytest.fixture(scope="module")
def one_process(two_ranks):
    return {"ops": rank_checks.slab_ops(None, {**MINI, "device": "cpu"}),
            "march": two_ranks[0]["plain_march"]}


@pytest.mark.parametrize("n_j,levels,size,rows", [
    (1113, 4, 4, [(0, 280), (280, 560), (560, 840), (840, 1113)]),
    (16, 1, 2, [(0, 8), (8, 16)]),
    (57, 3, 3, [(0, 20), (20, 40), (40, 57)]),
    (57, 3, 2, [(0, 28), (28, 57)]),
], ids=["restart-4", "zline16-2", "mini-3", "mini-2"])
def test_partition_is_aligned_to_the_coarsest_level(n_j, levels, size,
                                                    rows):
    lay = SlabLayout(n_j, levels, size)
    assert [lay.rows(r) for r in range(size)] == rows
    f = 1 << (levels - 1)
    for k in range(levels):
        got = [lay.rows(r, k) for r in range(size)]
        # every level's slabs tile its rows; the inner boundaries are the
        # coarsest boundaries scaled by 2^(L-1-k)
        assert got[0][0] == 0 and got[-1][1] == lay.n_rows(k)
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
        assert all(lo % (f >> k) == 0 for lo, _ in got)


def test_partition_refuses_fewer_coarse_rows_than_ranks():
    with pytest.raises(ValueError, match="cannot be split over 5 ranks"):
        SlabLayout(17, 3, 5)       # 4 coarse cell rows
    with pytest.raises(ValueError, match="do not coarsen"):
        SlabLayout(18, 3, 2)


def test_split_and_join_a_whole_state():
    u = np.arange(57 * 17 * 3, dtype=np.float64).reshape(-1, 3)
    parts = split_state(u, 17, 57, 3, 3)
    assert [len(p) // 17 for p in parts] == [20, 20, 17]
    assert np.array_equal(join_state(parts), u)


@pytest.mark.parametrize("fixture", ["two_ranks", "three_ranks"])
def test_slab_pieces_bit_for_bit(fixture, request):
    res = request.getfixturevalue(fixture)
    for r in res:
        assert all(r["units"]["equal"].values()), r["units"]


@pytest.mark.parametrize("fixture", ["two_ranks", "three_ranks"])
def test_operators_and_vcycle_bit_for_bit(fixture, request, one_process):
    res = [r["ops"] for r in request.getfixturevalue(fixture)]
    ref = one_process["ops"]
    assert [r["rows"][0] for r in res[1:]] == [r["rows"][1]
                                               for r in res[:-1]]
    for k in OPS:
        got = torch.cat([r[k] for r in res])
        assert torch.equal(got, ref[k]), k
    # the control: a halo exchange that drops the row from below
    control = torch.cat([r["control_F"] for r in res])
    assert not torch.equal(control, ref["F"])
    assert not torch.allclose(control, ref["F"], rtol=1e-3)


def test_zline16_step_matches_jax_use_gspmd(two_ranks, jax_zline16):
    got = two_ranks[0]["zline16"]
    assert got["rows"][0]["newton_iterations"] >= 1
    np.testing.assert_allclose(got["u"].numpy(), jax_zline16[1],
                               rtol=1e-10, atol=1e-12)


def test_miniature_production_matches_one_process(two_ranks, one_process):
    ref = one_process["march"]
    got = two_ranks[0]["march"]
    keys = ("n_accepted", "n_rejected", "newton_iterations")
    for a, b in zip(got["rows"], ref["rows"]):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
        assert a["t"] == pytest.approx(b["t"], rel=1e-12)
    np.testing.assert_allclose(got["u"].numpy(), ref["u"].numpy(),
                               rtol=5e-5, atol=1e-7)
    # every rank took the same decisions
    assert [r["t"] for r in two_ranks[1]["march"]["rows"]] == [
        r["t"] for r in got["rows"]]


def test_miniature_production_matches_jax_numbers(two_ranks):
    got = two_ranks[0]["march"]
    rows = [r for r in got["rows"] if r["item"] == "advance"]
    assert len(rows) == len(JAX_GSPMD)
    for row, ref in zip(rows, JAX_GSPMD):
        assert (row["n_accepted"], row["n_rejected"]) == (
            ref["n_accepted"], ref["n_rejected"])
        assert row["t"] == pytest.approx(ref["t"], rel=5e-6)
        assert row["dt"] == pytest.approx(ref["dt"], rel=5e-6)
        np.testing.assert_allclose(row["col_norms"], ref["col_norms"],
                                   rtol=5e-5)


def test_gspmd_identity_rule(two_ranks, one_process):
    """`fedm_tpu_torch.gspmd_identity`'s rule (the JAX tool's) on the
    miniature run: identity holds; a state 1e-3 off refuses it. Its
    model spec reads a checkpoint without window meta as bench.py's
    restart."""
    from fedm_tpu_torch import gspmd_identity

    many = [r["march"] for r in two_ranks]
    got = gspmd_identity.identity(one_process["march"], many)
    assert got["identity_ok"] and got["accepted_equal"]
    assert got["max_rel_field_dev"] < 5e-4
    off = dict(many[0], u=many[0]["u"] * (1 + 1e-3))
    assert not gspmd_identity.identity(one_process["march"],
                                       [off])["identity_ok"]
    spec = gspmd_identity.spec_for(
        Path(__file__).resolve().parent.parent / "bench_assets"
        / "bagheri_dz1e-5_ckpt.npz", 4)
    assert spec["cfg"]["z_corridor"] == (0.0, 1.08e-2, 1e-5)
    assert spec["plan"] == ["advance"] * 4 and spec["float32"]


def test_thread_emulated_ranks_hold_the_slab_pieces():
    """3 ranks as threads of one process (`slab_probe.ThreadGroup`) run
    the slab pieces bit for bit with the whole grid's, as gloo ranks do."""
    res = emulate(rank_checks.slab_units, 3, "cpu", (UNITS,))
    assert [r["rank"] for r in res] == [0, 1, 2]
    for r in res:
        assert all(r["equal"].values()), r


def test_judge_holds_rounding_and_refuses_the_controls(two_ranks,
                                                       one_process):
    """`slab_probe.judge`, the per-column hold of an operator whose
    difference on the card is count rounding: one process's operators hold
    to themselves and to a relative change of one float32 ulp (float32
    operators); the same rounded to bfloat16 do not, nor does the residual
    without the halo row from below, nor that residual in its Poisson row
    alone, nor the float32 residual as the float64 defect."""
    ref = one_process["ops"]
    ulp = torch.finfo(torch.float32).eps
    for k in OPS:
        anchor = anchor_of(k, ref)
        assert judge(ref[k], ref[k], anchor)["ok"], k
        if ref[k].dtype == torch.float32:
            assert judge(ref[k] * (1 + ulp), ref[k], anchor)["ok"], k
        assert not judge(ref[k].to(torch.bfloat16), ref[k],
                         anchor)["ok"], k
    control = torch.cat([r["ops"]["control_F"] for r in two_ranks])
    assert not judge(control, ref["F"], ref["F64"])["ok"]
    poisson = ref["F"].clone()
    poisson[:, 2] = control[:, 2]
    assert not judge(poisson, ref["F"], ref["F64"])["ok"]
    assert not judge(ref["F"].double(), ref["F64"], ref["F"])["ok"]


def test_one_rank_slab_march_equals_one_process(two_ranks, one_process):
    """The miniature production run on one slab of a one-rank group (the
    slab code, every collective the identity) marches as one process does,
    bit for bit: what R ranks add is the ranks' own sums."""
    got = two_ranks[1]["march1"]
    ref = one_process["march"]
    assert torch.equal(got["u"], ref["u"])
    skip = ("s", "collectives")
    assert [{k: v for k, v in r.items() if k not in skip}
            for r in got["rows"]] == [{k: v for k, v in r.items()
                                       if k not in skip}
                                      for r in ref["rows"]]


class _CountRounding(TorchDispatchMode):
    """A batched GEMM that rounds its results up by one ulp at the given
    batch counts: what a GEMM whose kernel follows the batch count does on
    the card."""

    def __init__(self, counts):
        super().__init__()
        self.counts = set(counts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func is torch.ops.aten.bmm.default
                and args[0].shape[0] in self.counts):
            out = torch.nextafter(out, torch.full_like(out, torch.inf))
        return out


def test_probe_names_count_rounding(monkeypatch):
    """`slab_probe.probe` on 2 ranks emulated as threads, with the batched
    GEMMs rounding otherwise at the ranks' cell counts (`_CountRounding`):
    the residual's first differing op is that GEMM at equal inputs (so
    too in float64), so every operator through the cell kernel is exempt;
    the V-cycle is not.
    And `exemptions` where only `block_apply` rounds so: M alone."""
    from fedm_tpu_torch.parallel import slab_probe

    spec, R = slab_probe.case("mini")
    counts = (1792, 1856)
    rank_ops = slab_probe._rank_ops

    def rounded(group, s):
        if group is None:
            return rank_ops(group, s)
        with _CountRounding(counts):
            return rank_ops(group, s)

    monkeypatch.setattr(slab_probe, "_rank_ops", rounded)
    with _CountRounding(counts):
        out = slab_probe.probe(spec, R, "cpu")
    assert out["cells"] == list(counts)
    first = out["kernels"]["F"][0][0]["ops"]
    assert first["op"] == "aten.bmm.default" and first["count_rounding"]
    assert out["exempt"] == {k: k != "V" for k in OPS}
    parts = [{"invert_blocks_equal": True, "block_apply_equal": q}
             for q in (True, False)]
    only_m = slab_probe.exemptions({}, True, parts, True)
    assert only_m == {k: k == "M" for k in only_m}
    assert not slab_probe.exemptions({}, True, parts, False)["M"]
    assert not slab_probe.exemptions({}, False, parts, True)["M"]
