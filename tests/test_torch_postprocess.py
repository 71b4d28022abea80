"""The post-processing entry points (`python -m fedm_tpu_torch.export_series`
and `.glow_report`) against the JAX package's `tools/export_series.py` and
`tools/glow_report.py`, called through their functions, on the same seeded
run directories (`tools/series_checkpoints.py`): a small streamer window
trail (two corridors, a reused mesh, a skipped dof mismatch, a duplicate)
and glow runs at 8 x 8 and at the tools' fixed 64 x 64.

The JAX glow tools read the reference's `4_particles` tree, which is not in
the repository: their `GlowConfig` is pointed at the synthetic argon tree
here (the mesh and the state layout, all they read, do not depend on it).
Every PVD and VTU file is held byte for byte; the report's numbers to
1e-12 relative (both compute them in numpy from the same arrays: equal).
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
import fedm_tpu.models.glow as jglow
from fedm_tpu.models.argon_synth import generate_argon_input
from fedm_tpu_torch import export_series, glow_report
from fedm_tpu_torch.io.vtu import read_vtu

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import series_checkpoints as seeded  # noqa: E402


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("runs")
    seeded.streamer_trail(base / "streamer", **seeded.STREAMER_SMALL)
    seeded.glow_run(base / "glow_small", seeded.GLOW_SMALL["n_dofs"])
    seeded.glow_run(base / "glow50", seeded.GLOW50["n_dofs"], seed=1)
    return base


@pytest.fixture
def jax_glow_synth(tmp_path, monkeypatch):
    """The JAX tools' `GlowConfig` on the synthetic argon tree."""
    generate_argon_input(tmp_path / "file_input", model="argon_synth")
    real = jglow.GlowConfig

    def synth(**kw):
        kw.update(model="argon_synth", file_input=tmp_path / "file_input")
        return real(**kw)

    monkeypatch.setattr(jglow, "GlowConfig", synth)


def _tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _same_files(port: Path, ref: Path, n_files: int) -> None:
    got, want = _tree(port), _tree(ref)
    assert sorted(got) == sorted(want) and len(got) == n_files
    for name in want:
        assert got[name] == want[name], name


def test_streamer_series(runs, tmp_path, capsys):
    jax_tool = _tool("export_series")
    (tmp_path / "jax").mkdir()
    jax_tool.export_streamer(runs / "streamer", tmp_path / "jax")
    jax_out = capsys.readouterr().out
    (tmp_path / "port").mkdir()
    assert export_series.main(["--run", str(runs / "streamer"), "--model",
                               "streamer", "--out", str(tmp_path / "port"),
                               "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    # 3 snapshots (the fourth checkpoint skipped, checkpoint.npz a
    # duplicate) and the collection
    _same_files(tmp_path / "port", tmp_path / "jax", 4)
    assert port_out.startswith(jax_out) and "skip checkpoint_000003" in \
        jax_out
    vals = read_vtu(tmp_path / "port" / "fields000002.vtu", "E_magnitude")
    assert vals.shape == (seeded.STREAMER_SMALL["n_dofs"],) \
        and np.isfinite(vals).all() and vals.max() > 0


def test_streamer_trail_and_meshes(runs):
    """`checkpoint_trail` de-duplicates and sorts, as the JAX tool's;
    `streamer_mesh` rebuilds the JAX tool's mesh."""
    jax_tool = _tool("export_series")
    ref = jax_tool.checkpoint_trail(runs / "streamer")
    got = export_series.checkpoint_trail(runs / "streamer", "cpu")
    assert [(p.name, s.t, s.n_accepted) for p, s, _ in got] == \
        [(p.name, s.t, s.n_accepted) for p, s, _ in ref]
    assert len(got) == 4
    for (_, s, meta), (_, r, rmeta) in zip(got, ref):
        assert np.array_equal(s.u.numpy(), np.asarray(r.u))
        assert sorted(meta) == sorted(rmeta)
    jm = jax_tool.streamer_mesh(ref[0][2])
    tm = export_series.streamer_mesh(got[0][2], "cpu")
    assert np.array_equal(tm.space.dof_coords,
                          np.asarray(jm.space.dof_coords))
    assert np.array_equal(tm.mesh.cells, np.asarray(jm.mesh.cells))


@pytest.mark.usefixtures("jax_glow_synth")
def test_glow_series(runs, tmp_path, capsys):
    """The entry point at its fixed 64 x 64, and the function at 8 x 8."""
    jax_tool = _tool("export_series")
    jax_tool.export_glow(runs / "glow50", tmp_path / "jax")
    jax_tool.export_glow(runs / "glow_small", tmp_path / "jax_small",
                         nx=8, ny=8)
    jax_out = capsys.readouterr().out
    (tmp_path / "port").mkdir()
    assert export_series.main(["--run", str(runs / "glow50"), "--model",
                               "glow", "--out", str(tmp_path / "port"),
                               "--device", "cpu"]) == 0
    export_series.export_glow(runs / "glow_small", tmp_path / "port_small",
                              nx=8, ny=8, device="cpu")
    port_out = capsys.readouterr().out
    # 6 fields x (2 snapshots + the collection)
    _same_files(tmp_path / "port", tmp_path / "jax", 18)
    _same_files(tmp_path / "port_small", tmp_path / "jax_small", 18)
    assert port_out.replace(f"series written under {tmp_path / 'port'}\n",
                            "") == jax_out


@pytest.mark.usefixtures("jax_glow_synth")
def test_glow_report(runs, tmp_path, capsys):
    jax_tool = _tool("glow_report")
    ref = jax_tool.analyze(jax_tool.profiles(runs / "glow_small", 8, 8))
    out = tmp_path / "report.md"
    assert glow_report.main([str(runs / "glow_small"), "--nx", "8", "--ny",
                             "8", "--out", str(out), "--device", "cpu"]) == 0
    got = glow_report.analyze(glow_report.profiles(runs / "glow_small", 8,
                                                   8, device="cpu"))
    assert list(got) == list(ref) and got["checks"] == ref["checks"]
    for k, v in ref.items():
        if isinstance(v, (float, list)):
            assert np.allclose(got[k], v, rtol=1e-12, atol=0), k
        else:
            assert got[k] == v, k
    md = out.read_text()
    assert md == glow_report.report(runs / "glow_small", got)
    assert md in capsys.readouterr().out
    # a mesh that does not fit the checkpoint
    with pytest.raises(AssertionError, match="pass the run's --nx/--ny"):
        glow_report.profiles(runs / "glow_small", 16, 16, device="cpu")


@pytest.mark.parametrize("argv", [
    ["fedm_tpu_torch.export_series", "--run", "r", "--model", "glow",
     "--out", "o"],
    ["fedm_tpu_torch.glow_report", "r"]], ids=["export_series",
                                              "glow_report"])
def test_no_gpu_exits_1(argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m"] + argv, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode == 1 and "--device cpu" in res.stderr
    assert not (tmp_path / "o").exists()
