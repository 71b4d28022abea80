"""The port's entry point `python -m fedm_tpu_torch.bagheri_run`: its
presets are the JAX tool's (`tools/bagheri_run.py`); --devices N runs N
gloo ranks on z-slabs here, under mg-zline and under --precond mg (the
point-smoothed geometric multigrid, `SlabGeometricMG` on every rank),
rank 0's checkpoint held to the one-process run's, and refuses the direct
rescue (single-card, as in the JAX tool) and more ranks than cards;
every other option of the JAX tool builds and steps a
small run (the `bagheri14` preset as written, with its
direct rescue, at full size), and a CPU run on a small moving window
(float32 with the float64 defect, the bagheri14 solver options) starts
from t = 0, moves its window, writes checkpoints with meta and logs, and
resumes from them: on the same mesh, and across a change of the window's
dz (top-hat remap, BDF history restarted).
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from fedm_tpu_torch import bagheri_run
from fedm_tpu_torch.io import load_checkpoint

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bagheri_run", ROOT / "tools" / "bagheri_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_presets_are_the_reference_tools():
    assert bagheri_run.PRESETS == _jax_tool().PRESETS


def test_preset_typo_is_refused(monkeypatch, capsys):
    monkeypatch.setitem(bagheri_run.PRESETS, "typo",
                        dict(window_dz=1e-5, windw_span=1e-3))
    with pytest.raises(SystemExit):
        bagheri_run.parse_args(["--out", "x"])
    assert "unknown keys: ['windw_span']" in capsys.readouterr().err


def test_devices_refuses_the_direct_rescue_and_more_ranks_than_cards(
        tmp_path, capsys):
    with pytest.raises(SystemExit):
        bagheri_run.parse_args(["--out", "x", "--devices", "2",
                                "--preset", "bagheri14"])
    assert "--direct-rescue is single-card" in capsys.readouterr().err
    # one rank per card: this machine has no CUDA device at all
    with pytest.raises(ValueError, match="CUDA devices, one each"):
        bagheri_run.main(["--out", str(tmp_path), "--devices", "5",
                          "--no-direct-rescue", "--preset", "bagheri14"])


def test_direct_rescue_needs_no_fallback(capsys):
    """As the JAX tool asserts: the rescue replaces the float64 model."""
    with pytest.raises(SystemExit):
        bagheri_run.parse_args(["--out", "x", "--direct-rescue",
                                "--fallback"])
    assert "--direct-rescue replaces" in capsys.readouterr().err


# the options the port refused before this slice; each builds its run on
# the small window and takes one advance
@pytest.mark.parametrize("argv,check", [
    (["--preset", "bagheri14"], "direct"),
    (["--direct-rescue"], "direct"),
    (["--tzline"], "tzline"),
    (["--row-scaled"], "row_scaled"),
    (["--precond", "zline"], "zline"),
    (["--precond", "mg"], "mg"),
], ids=["preset-direct-rescue", "direct-rescue", "tzline", "row-scaled",
        "zline", "mg"])
def test_ported_options_build_and_step(argv, check, tmp_path):
    from fedm_tpu_torch.solvers.direct import DirectNewton
    from fedm_tpu_torch.solvers.multigrid import GeometricMultigrid

    args = bagheri_run.parse_args([*argv, *SMALL_RUN, "--out",
                                   str(tmp_path)])
    model, fallback = bagheri_run.build_models(
        args, bagheri_run.window_corr(1e-2, args.window_span,
                                      args.window_dz))
    driver = bagheri_run.build_driver(args, model, fallback)
    system = model.system
    assert {"direct": isinstance(driver.fallback_system, DirectNewton),
            "tzline": system._tzline is not None,
            "row_scaled": system.row_scaled,
            "zline": model._smg is None and system._ell is not None,
            "mg": isinstance(system._ell[1].__self__, GeometricMultigrid),
            }[check]
    state = driver.advance(model.initial_state())
    assert state.n_accepted == 1 and np.isfinite(state.u.numpy()).all()


def test_bagheri14_preset_runs_as_written(tmp_path, capsys):
    """The flagship preset with its direct rescue, at full size (30,305
    dofs), one step from t = 0."""
    assert bagheri_run.main(["--preset", "bagheri14", "--device", "cpu",
                             "--max-steps", "1", "--out",
                             str(tmp_path)]) == 0
    log = capsys.readouterr().out
    assert "mesh: 30305 dofs" in log and "STOPPED" in log
    assert json.loads(log.split("protocol: ", 1)[1].splitlines()[0])[
        "direct_rescue"]
    state = load_checkpoint(tmp_path / "checkpoint.npz", device="cpu")
    assert state.n_accepted == 1


@pytest.mark.parametrize("preset,refused", [
    ("bagheri14", True), ("bagheri14-fullgap", False)])
def test_f64_is_refused_on_a_moving_window(preset, refused, capsys):
    """As in the reference tool: --f64 takes the static full-gap mesh, not
    the moving window."""
    argv = ["--preset", preset, "--no-direct-rescue", "--f64", "--out", "x"]
    if refused:
        with pytest.raises(SystemExit):
            bagheri_run.parse_args(argv)
        assert "--f64 with a moving window" in capsys.readouterr().err
    else:
        assert bagheri_run.parse_args(argv).f64


def test_bagheri14_preset_parses():
    args = bagheri_run.parse_args(["--preset", "bagheri14",
                                   "--no-direct-rescue", "--out", "x"])
    assert (args.window_dz, args.tail_cells, args.hi_res, args.stab,
            args.predictor, args.fail_dt_cap, args.true_res_rescue,
            args.direct_rescue, args.device) == (
        1e-5, "10,48", True, "off", 1.0, 0.7, 1.0, False, "cuda")


def test_window_corr_matches_the_reference_placement():
    span, dz = 1.5e-3, 1e-5
    assert bagheri_run.window_corr(1e-2, span, dz) == (
        1e-2 - 0.6 * span, 1e-2 + 0.4 * span, dz)
    assert bagheri_run.window_corr(0.0, span, dz) == (1e-4, 1e-4 + span, dz)
    assert bagheri_run.window_corr(1.2e-2, span, dz) == (
        1.19e-2 - span, 1.19e-2, dz)


SMALL_RUN = ["--device", "cpu", "--window-dz", "1e-4", "--tail-cells",
             "4,8", "--dr", "2e-4", "--r1", "2e-3", "--no-fallback",
             "--hi-res", "--stab", "off", "--linear-tol", "1e-2",
             "--predictor", "1.0", "--fail-dt-cap", "0.7",
             "--true-res-rescue", "1.0", "--report-every", "1",
             "--checkpoint-every", "2", "--diag-guards"]


def test_run_moves_the_window_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                      capsys):
    # every axis node counts as streamer: the front sits at the cathode, so
    # the first report moves the window down to its clamp at z = 1e-4
    monkeypatch.setattr(bagheri_run, "FRONT_DENSITY", 0.0)
    out = tmp_path / "run"
    assert bagheri_run.main([*SMALL_RUN, "--out", str(out),
                             "--max-steps", "3"]) == 0
    log = capsys.readouterr().out
    assert "REMESH: window (0.0091" in log and "REMESH done" in log
    assert "n_guarded=" in log
    state, meta = load_checkpoint(out / "checkpoint.npz", device="cpu",
                                  with_meta=True)
    assert state.n_accepted == 3 and state.t > 0
    assert tuple(float(v) for v in meta["z_corridor"]) == (1e-4, 1.6e-3,
                                                           1e-4)
    assert tuple(int(v) for v in meta["z_tail_cells"]) == (4, 8)
    assert json.loads(str(meta["protocol"]))["window_dz"] == 1e-4
    assert json.loads((out / "window.json").read_text()) == [1e-4, 1.6e-3,
                                                             1e-4]
    n_err = len((out / "relative error.log").read_text().splitlines())
    newton = (out / "newton.log").read_text().splitlines()
    assert [line.split()[0] for line in newton] == ["1", "2", "3"]
    assert n_err >= 3

    # same-mesh resume: the window's position comes from the meta
    assert bagheri_run.main([*SMALL_RUN, "--out", str(out), "--resume",
                             "--max-steps", "4"]) == 0
    log = capsys.readouterr().out
    assert f"resumed from {out / 'checkpoint.npz'}: t={state.t:.4e}" in log
    assert "z_corridor=(1.0000e-04,1.6000e-03,dz=0.0001) [moving]" in log
    assert "remapped" not in log
    resumed = load_checkpoint(out / "checkpoint.npz", device="cpu")
    assert resumed.n_accepted == 4 and resumed.t > state.t

    # a resume at half the window's dz: top-hat remap, BDF restart
    fine = [a if a != "1e-4" else "5e-5" for a in SMALL_RUN]
    assert bagheri_run.main([*fine, "--out", str(out), "--resume",
                             "--resume-dt", "1e-13", "--max-steps", "5"]) == 0
    log = capsys.readouterr().out
    assert "remapped checkpoint z-lines" in log
    assert "BDF history restarted (backward-Euler first step, " \
           "dt=1.000e-13)" in log
    state, meta = load_checkpoint(out / "checkpoint.npz", device="cpu",
                                  with_meta=True)
    assert state.n_accepted == 5
    assert float(meta["z_corridor"][2]) == 5e-5
    assert np.isfinite(state.u.numpy()).all()


def test_devices_on_ranks_matches_one_process(tmp_path, capfd):
    """--devices 2 --device cpu: two gloo ranks on z-slabs take the small
    window's first steps; rank 0 prints the reports and writes the
    checkpoint (the gathered state) and the logs, held to the one-process
    run's: the same counts and t, the fields at
    tests/parallel/test_gspmd_production.py's rtol 5e-5, atol 1e-7."""
    _ranks_match_one_process(tmp_path, capfd, "mg-zline", "SlabPoissonMG")


def test_devices_mg_on_ranks_matches_one_process(tmp_path, capfd):
    """The same under --precond mg: the point-smoothed geometric
    multigrid on the slabs."""
    _ranks_match_one_process(tmp_path, capfd, "mg", "SlabGeometricMG")


def _ranks_match_one_process(tmp_path, capfd, precond, solve):
    argv = [a for a in SMALL_RUN if a != "--diag-guards"] + [
        "--max-steps", "2", "--precond", precond]
    assert bagheri_run.main([*argv, "--out", str(tmp_path / "one")]) == 0
    assert bagheri_run.main([*argv, "--devices", "2", "--out",
                             str(tmp_path / "two")]) == 0
    log = capfd.readouterr().out
    assert (f"2 ranks on z-slabs, node rows [16, 17], Poisson row {solve}"
            in log)
    one, meta1 = load_checkpoint(tmp_path / "one" / "checkpoint.npz",
                                 device="cpu", with_meta=True)
    two, meta2 = load_checkpoint(tmp_path / "two" / "checkpoint.npz",
                                 device="cpu", with_meta=True)
    assert (two.n_accepted, two.n_rejected) == (one.n_accepted,
                                                one.n_rejected) == (2, 0)
    assert two.t == pytest.approx(one.t, rel=1e-12)
    for f in ("u", "u_old", "u_old1"):
        np.testing.assert_allclose(getattr(two, f).numpy(),
                                   getattr(one, f).numpy(), rtol=5e-5,
                                   atol=1e-7)
    assert list(meta2["z_corridor"]) == list(meta1["z_corridor"])
    newton = (tmp_path / "two" / "newton.log").read_text().splitlines()
    assert [line.split()[0] for line in newton] == ["1", "2"]


def test_devices_mg_puts_every_rank_on_the_geometric_multigrid():
    """--precond mg with --devices 2: on each rank the model and its
    float64 escalation model (a static mesh: the escalation does not
    follow window moves) take the point-smoothed geometric multigrid on
    the rank's slab."""
    from fedm_tpu_torch.parallel import rank_checks, ranks

    spec = {"bagheri_argv": ["--dz", "4e-4", "--nx", "8", "--dr", "4e-4",
                             "--r1", "2e-3", "--precond", "mg",
                             "--devices", "2"]}
    res = ranks.launch(rank_checks.bagheri_models, 2, "cpu", (spec,),
                       timeout=300)
    assert [r["rank"] for r in res] == [0, 1]
    for r in res:
        assert r["solves"] == ["SlabGeometricMG", "SlabGeometricMG"]
        assert r["rows"] == [(0, 16), (16, 33)][r["rank"]]


def test_counted_run_logs_each_advance_on_every_rank(tmp_path):
    """`python -m fedm_tpu_torch.parallel.counted_run COUNTS argv`: the
    entry point as a process on 2 gloo ranks under --precond mg, with one
    line per advance and rank of counts that agree between the ranks and
    with the checkpoint; imported, the module changes nothing."""
    import subprocess
    import sys

    from fedm_tpu_torch.parallel import counted_run  # noqa: F401
    from fedm_tpu_torch.solvers import newton

    assert newton.bicgstab.__module__ == "fedm_tpu_torch.solvers.linear"
    argv = [a for a in SMALL_RUN if a != "--diag-guards"] + [
        "--max-steps", "2", "--precond", "mg", "--devices", "2"]
    counts = tmp_path / "counts.jsonl"
    run = subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.parallel.counted_run",
         str(counts), *argv, "--out", str(tmp_path / "out")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    rows = [json.loads(line) for line in counts.read_text().splitlines()]
    by_rank = [[r for r in rows if r["rank"] == q] for q in (0, 1)]
    assert [len(r) for r in by_rank] == [2, 2]
    keys = ("n_accepted", "n_rejected", "t", "dt", "newton", "krylov")
    assert ([{k: r[k] for k in keys} for r in by_rank[0]]
            == [{k: r[k] for k in keys} for r in by_rank[1]])
    assert all(r["newton"] >= 1 and r["krylov"] >= r["newton"]
               for r in rows)
    state = load_checkpoint(tmp_path / "out" / "checkpoint.npz",
                            device="cpu")
    assert (state.n_accepted, state.t) == (by_rank[0][-1]["n_accepted"],
                                           by_rank[0][-1]["t"])
