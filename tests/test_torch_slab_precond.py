"""The Poisson-row solves of the structured streamer on z-slabs that came
last to the port (`CoupledSystem.use_gspmd`, `parallel.slabs`): the
point-smoothed geometric multigrid (`--precond mg`, `SlabGeometricMG`)
and the Chebyshev solve of `enable_elliptic_precond` (`SlabChebyshev`),
one gloo rank per slab, against one process and against the JAX
package's `use_gspmd`:

- on the miniature production model of `tests/test_torch_slabs.py`
  (float32 with the float64 defect, 3 levels, 33 x 57 nodes) with
  poisson_precond="mg", with the Chebyshev solve installed, and with the
  model's z-line-smoothed `GeometricMultigrid` in place of the structured
  V-cycle: one application of the slab solve (V) and of the whole
  preconditioner (M) on 2 and 3 ranks equals one process's bit for bit;
  the controls, the point smoother without its halo row from below and
  the Chebyshev solve with lmax scaled by (1 + 1e-6), do not;
- one step on 2 ranks, in float64 from the JAX package's initial state,
  against the JAX package's live `use_gspmd` over 2 virtual CPU devices,
  at `test_zline16_step_matches_jax_use_gspmd`'s tolerance;
- one advance on 2 ranks (float32) against the JAX package's numbers of
  `JAX_PLATFORMS=cpu python tools/port_reference_gspmd.py --devices 2
  --precond mg` and `--cheb`, pinned below: equal counts, t and dt
  within 5e-6 relative, column norms within 5e-5 (as the mg-zline
  miniature is held);
- the hierarchy `--precond mg` builds on the full-gap mesh (the preset
  `bagheri14-fullgap`): the JAX package's levels and grids, its
  coarsest level split over 4 ranks; a hierarchy without stencils or
  with P1 transfers, and a preconditioner the slabs do not know, are
  refused before the system changes.

Every tolerance here is per column of the state; the einsum exception of
the cards does not arise on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import fedm_tpu  # noqa: F401
from fedm_tpu.model.system import StepParams as JParams
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu.solvers.newton import NewtonConfig as JaxNewton
from fedm_tpu_torch.parallel import rank_checks, ranks

LAUNCH_S = 300
SPAN, DZ = 1.5e-3, 5e-5
CFG = dict(z_corridor=(8.5e-3, 8.5e-3 + SPAN, DZ), r_corridor=(2e-3, 2e-4),
           z_tail_cells=(12, 12), mg_levels=3, poisson_precond="mg-zline",
           density_floor=1e13)
NEWTON = dict(rtol=1e-3, max_iter=20, linear_tol=1e-4, linear_maxiter=200,
              accept_reduction=3e-2, host_loop=True, hi_residual=True)
MINI = {"cfg": CFG, "newton": NEWTON, "float32": True}
# the solves by `rank_checks.slab_model`'s spec `poisson`, and the slab
# form `use_gspmd` installs for each
SOLVES = {"mg": "SlabGeometricMG", "chebyshev": "SlabChebyshev",
          "geometric": "SlabGeometricMG"}
STEP = (5e-12, 5e-12, 1e30)
# tools/port_reference_gspmd.py --devices 2 --precond mg / --cheb (JAX
# use_gspmd on 2 virtual CPU devices): one advance's counts, t, dt and
# the column 2-norms of u
JAX_ADVANCE = {
    "mg": {"n_accepted": 1, "n_rejected": 0, "t": 5e-12, "dt": 5e-12,
           "col_norms": [1346.1285021130316, 1298.335317744016,
                         627596.5477172926]},
    "chebyshev": {"n_accepted": 1, "n_rejected": 0, "t": 5e-12,
                  "dt": 5e-12,
                  "col_norms": [1346.1285021129875, 1298.3353177123042,
                                627596.5469032158]}}


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


def _jax_model(name, dtype=jnp.float64):
    cfg = dict(CFG, poisson_precond="mg") if name == "mg" else CFG
    m = JaxModel(JaxConfig(newton=JaxNewton(**NEWTON), dtype=dtype, **cfg))
    m.system.use_gather_scatter()
    if name == "chebyshev":
        m.system.enable_elliptic_precond(2)
    return m


@pytest.fixture(scope="module")
def jax_steps():
    """Per solve: the JAX float64 miniature's initial state and one step
    from it under its live `use_gspmd` on 2 virtual devices."""
    out = {}
    for name in ("mg", "chebyshev"):
        m = _jax_model(name)
        st = m.initial_state()
        m.system.use_gspmd(_jax_mesh(2))
        u1, info = m.system.step(st.u, st.u, st.u, {},
                                 JParams(*(jnp.asarray(x) for x in STEP)))
        assert bool(info.converged)
        out[name] = (np.asarray(st.u), np.asarray(u1))
    return out


def _spec(name: str) -> dict:
    return {**MINI, "poisson": name}


def _step_spec(name: str, u0: np.ndarray) -> dict:
    return {"cfg": CFG, "newton": NEWTON, "poisson": name,
            "u": {"u": u0, "u_old": u0, "u_old1": u0, "t": 0.0,
                  "dt": STEP[1], "dt_old": STEP[2]},
            "plan": [("step", STEP)]}


@pytest.fixture(scope="module")
def two_ranks(jax_steps):
    jobs = [(f"ops_{k}", "slab_ops", _spec(k)) for k in SOLVES]
    jobs += [(f"advance_{k}", "slab_march", {**_spec(k), "plan": ["advance"]})
             for k in ("mg", "chebyshev")]
    jobs += [(f"step_{k}", "slab_march", _step_spec(k, jax_steps[k][0]))
             for k in ("mg", "chebyshev")]
    return ranks.launch(rank_checks.several, 2, "cpu", (jobs,),
                        timeout=LAUNCH_S)


@pytest.fixture(scope="module")
def three_ranks():
    return ranks.launch(rank_checks.several, 3, "cpu", (
        [(f"ops_{k}", "slab_ops", _spec(k)) for k in ("mg", "chebyshev")],),
        timeout=LAUNCH_S)


@pytest.fixture(scope="module")
def one_process():
    return {k: rank_checks.slab_ops(None, {**_spec(k), "device": "cpu"})
            for k in SOLVES}


@pytest.mark.parametrize("fixture,name", [
    ("two_ranks", "mg"), ("two_ranks", "chebyshev"),
    ("two_ranks", "geometric"), ("three_ranks", "mg"),
    ("three_ranks", "chebyshev")])
def test_slab_solve_bit_for_bit(fixture, name, request, one_process):
    res = [r[f"ops_{name}"] for r in request.getfixturevalue(fixture)]
    ref = one_process[name]
    assert [r["poisson_solve"] for r in res] == [SOLVES[name]] * len(res)
    assert ref["poisson_solve"] != SOLVES[name]      # one process: whole
    for k in ("V", "M"):
        assert torch.equal(torch.cat([r[k] for r in res]), ref[k]), k


@pytest.mark.parametrize("fixture,name", [
    ("two_ranks", "mg"), ("two_ranks", "chebyshev"),
    ("three_ranks", "mg"), ("three_ranks", "chebyshev")])
def test_slab_solve_controls_are_refused(fixture, name, request,
                                         one_process):
    """The point smoother without its halo row from below, and the
    Chebyshev solve with lmax scaled by (1 + 1e-6), leave one process's
    answer."""
    res = request.getfixturevalue(fixture)
    ref = one_process[name]["V"]
    control = torch.cat([r[f"ops_{name}"]["control_V"] for r in res])
    assert not torch.equal(control, ref)


@pytest.mark.parametrize("name", ["mg", "chebyshev"])
def test_step_matches_jax_use_gspmd(name, two_ranks, jax_steps):
    got = two_ranks[0][f"step_{name}"]
    assert got["rows"][0]["newton_iterations"] >= 1
    np.testing.assert_allclose(got["u"].numpy(), jax_steps[name][1],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["mg", "chebyshev"])
def test_advance_matches_jax_numbers(name, two_ranks):
    row = two_ranks[0][f"advance_{name}"]["rows"][0]
    ref = JAX_ADVANCE[name]
    assert (row["n_accepted"], row["n_rejected"]) == (ref["n_accepted"],
                                                      ref["n_rejected"])
    assert row["t"] == pytest.approx(ref["t"], rel=5e-6)
    assert row["dt"] == pytest.approx(ref["dt"], rel=5e-6)
    np.testing.assert_allclose(row["col_norms"], ref["col_norms"],
                               rtol=5e-5)
    # every rank took the same decisions
    assert two_ranks[1][f"advance_{name}"]["rows"][0]["t"] == row["t"]


def _levels(xs: np.ndarray, zs: np.ndarray, mg_levels: int) -> list:
    """The JAX package's coarsening of the coordinate lines
    (`fedm_tpu/models/streamer.py`, poisson_precond "mg"): (n_r, n_z) per
    level."""
    out = [(len(xs), len(zs))]
    for _ in range(1, mg_levels):
        if (len(xs) - 1) % 2 or (len(zs) - 1) % 2:
            break
        if (len(xs) - 1) // 2 < 4 or (len(zs) - 1) // 2 < 4:
            break
        xs, zs = xs[::2], zs[::2]
        out.append((len(xs), len(zs)))
    return out


def test_fullgap_hierarchy_is_the_jax_packages(monkeypatch):
    """`--precond mg` on the `bagheri14-fullgap` mesh (182,265 nodes): the
    port's `_geometric_mg` builds the levels and grids of the JAX
    package's coarsening of the same coordinate lines (4 levels, 145 x
    1257 down to 19 x 158), whose coarsest 157 z-cell rows split over 4
    ranks. The hierarchy is captured, not built."""
    from fedm_tpu_torch import bagheri_run
    from fedm_tpu_torch.fem import FunctionSpace
    from fedm_tpu_torch.models import streamer
    from fedm_tpu_torch.parallel.slabs import SlabLayout

    args = bagheri_run.parse_args(["--preset", "bagheri14-fullgap",
                                   "--precond", "mg", "--out", "-"])
    kw = dict(z_corridor=bagheri_run.full_gap_corr(args.window_dz),
              z_tail_cells=(10, 10), r_corridor=(args.r1, args.dr),
              poisson_precond="mg")
    cfg = streamer.StreamerConfig(**kw)
    jcfg = JaxConfig(**kw)
    zs, xs = streamer.z_coords(cfg), streamer.r_coords(cfg)
    assert np.array_equal(zs, JaxModel._z_coords(jcfg))
    assert np.array_equal(xs, JaxModel._r_coords(jcfg))
    captured = {}

    class Capture:
        def __init__(self, spaces, masks, **kw):
            captured["grids"] = [(len(np.unique(s.dof_coords[:, 0])),
                                  len(np.unique(s.dof_coords[:, 1])))
                                 for s in spaces]
            captured["line_grids"] = kw["line_grids"]

    monkeypatch.setattr(streamer, "GeometricMultigrid", Capture)
    model = streamer.StreamerModel.__new__(streamer.StreamerModel)
    model.cfg, model.device = cfg, torch.device("cpu")
    model.mesh = streamer.make_mesh(cfg)
    model.space = FunctionSpace(model.mesh)
    model._geometric_mg()
    assert np.array_equal(np.unique(model.mesh.coords[:, 0]), xs)
    assert np.array_equal(np.unique(model.mesh.coords[:, 1]), zs)
    want = _levels(xs, zs, cfg.mg_levels)
    assert captured["grids"] == want
    assert want == [(145, 1257), (73, 629), (37, 315), (19, 158)]
    assert captured["line_grids"] is None
    lay = SlabLayout(want[0][1], len(want), 4)
    assert lay.J == [0, 40, 79, 118, 157]


def test_unknown_or_unsliceable_solves_are_refused():
    """A Poisson-row solve the slabs do not know, and a hierarchy with a
    P1 transfer, are refused before the system is put on slabs."""
    from fedm_tpu_torch.parallel.slabs import SlabGeometricMG, Slabs

    with ranks.one_rank("cpu") as g:
        m = rank_checks.slab_model(MINI, torch.device("cpu"))
        m.system.enable_elliptic_precond(2, solver=lambda r: r)
        with pytest.raises(ValueError, match="whose rows the slabs know"):
            m.system.use_gspmd(g)
        assert m.system.slabs is None
        mg = m._geometric_mg()
        mg.transfers[0] = ("a P1 transfer",)
        with pytest.raises(ValueError, match="P1"):
            SlabGeometricMG(mg, Slabs(g, 33, 57, 3))
        mg = m._geometric_mg()
        with pytest.raises(ValueError, match="not aligned"):
            SlabGeometricMG(mg, Slabs(g, 33, 57, 2))


@pytest.mark.parametrize("name", ["mg", "chebyshev"])
def test_probe_never_exempts_a_slab_solve(name, monkeypatch):
    """`slab_probe.probe` on 2 ranks emulated as threads, with the batched
    GEMMs rounding otherwise at the ranks' cell counts (as
    `test_torch_slabs.py::test_probe_names_count_rounding`): the geometric
    multigrid's V stays bit for bit (stencils and transfers only); the
    Chebyshev solve's V, whose slab stiffness product runs through the
    cell GEMM, leaves one card's, and then neither V nor M (whose Poisson
    row is that solve) is exempt: a slab solve is held bit for bit."""
    from fedm_tpu_torch.parallel import slab_probe
    from tests.test_torch_slabs import _CountRounding

    spec, R = slab_probe.case("mini")
    spec = {**spec, "poisson": name}
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
    assert out["ops"]["V"]["bitwise"] == (name == "mg")
    assert out["M_parts"]["poisson_row_equal"] == (name == "mg")
    assert not out["exempt"]["V"]
    assert out["exempt"]["M"] == (name == "mg")
