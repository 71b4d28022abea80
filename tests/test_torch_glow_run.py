"""The port's entry point `python -m fedm_tpu_torch.glow_run`: its presets
are the JAX tool's (`tools/glow_run.py`), its command line is the JAX
tool's plus --device, and a CPU run of the glow50
protocol on a crossed 8 x 8 mesh starts from t = 0 on the synthetic argon
tree it generates, writes a checkpoint with the protocol in its meta and
the logs, and resumes from it."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from fedm_tpu_torch import glow_run
from fedm_tpu_torch.io import load_checkpoint

ROOT = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_glow_run", ROOT / "tools" / "glow_run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_presets_are_the_reference_tools():
    assert glow_run.PRESETS == _jax_tool().PRESETS


def test_preset_typo_is_refused(monkeypatch, capsys):
    monkeypatch.setitem(glow_run.PRESETS, "typo", dict(f32=True, hi_ress=True))
    with pytest.raises(SystemExit):
        glow_run.parse_args(["--out", "x"])
    assert "unknown keys: ['hi_ress']" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--degree", "2"], ["--devices", "2"]],
                         ids=["p2", "devices"])
def test_options_not_ported_are_refused(argv, capsys):
    """The JAX tool has neither flag (its PlasmaModel is P1 only), so the
    port's command line is the JAX tool's plus --device: argparse rejects
    both as unrecognised arguments."""
    jax_source = (ROOT / "tools" / "glow_run.py").read_text()
    assert f'"{argv[0]}"' not in jax_source
    with pytest.raises(SystemExit):
        glow_run.parse_args(["--out", "x", *argv])
    err = capsys.readouterr().err
    assert f"unrecognized arguments: {' '.join(argv)}" in err


def test_preset_sets_the_glow50_protocol():
    args = glow_run.parse_args(["--preset", "glow50", "--out", "x"])
    assert (args.f32, args.hi_res, args.no_fallback, args.linear_tol,
            args.checkpoint_every, args.report_every) == (
        True, True, True, 1e-2, 100, 50)
    assert args.device == "cuda" and (args.nx, args.ny) == (64, 64)


def _run(out: Path, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.glow_run", "--preset",
         "glow50", "--device", "cpu", "--nx", "8", "--ny", "8",
         "--report-every", "1", "--out", str(out), *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_run_checkpoint_and_resume(tmp_path):
    out = tmp_path / "glow"
    r = _run(out, "--max-steps", "2")
    assert r.returncode == 0, r.stderr
    assert "mesh: 8x8, 145 dofs (725 unknowns), chemistry=argon_synth" \
        in r.stdout
    assert "STOPPED at t=" in r.stdout and "(2 accepted" in r.stdout
    assert (out / "file_input" / "argon_synth" / "speclist.cfg").exists()
    assert len((out / "newton.log").read_text().splitlines()) == 2
    assert len((out / "relative_error.log").read_text().splitlines()) >= 2
    state, meta = load_checkpoint(out / "checkpoint.npz", device="cpu",
                                  with_meta=True)
    protocol = json.loads(str(meta["protocol"]))
    assert protocol["preset"] == "glow50" and protocol["hi_res"] is True
    assert state.n_accepted == 2 and state.u.shape == (145, 5)

    r = _run(out, "--max-steps", "3", "--resume")
    assert r.returncode == 0, r.stderr
    assert f"resumed from {out / 'checkpoint.npz'}: t={state.t:.4e}, " \
        "2 steps" in r.stdout
    resumed = load_checkpoint(out / "checkpoint.npz", device="cpu")
    assert resumed.n_accepted == 3 and resumed.t > state.t


def test_help_names_the_synthetic_default():
    text = glow_run.build_parser().format_help()
    assert "synthetic argon" in text and "4_particles" in text
