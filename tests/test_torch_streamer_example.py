"""The port's streamer entry point, `python -m
fedm_tpu_torch.examples.streamer --quick -T 2e-11 --device cpu`, against the
JAX package's `examples/streamer.py --quick -T 2e-11`: the same output
tree; the model log, the mesh files and the PVD collections byte for byte;
the same printed lines but for the wall times; `relative error.log` with
the same dt columns and errors within 1e-11 relative (CPU gap 3.6e-15);
the VTU series within 1e-11 of each field's max (CPU gap 7.3e-15; the
potential series is NaN where exp(Phi) overflows, in both packages, as the
reference's extract expression makes it). Without a CUDA device the entry
point refuses to run unless told `--device cpu`."""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import fedm_tpu  # noqa: F401
from fedm_tpu.io import files as jax_files
from fedm_tpu_torch.io import read_vtu

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-11
ARGS = ("--quick", "-T", "2e-11")
SERIES = {"Ions": "number density/Ions",
          "electrons": "number density/electrons",
          "Phi": "potential/Phi"}
TREE = sorted(
    ["mesh", "mesh/mesh info.txt", "mesh/mesh.vtu", "model.log",
     "number density", "potential", "relative error.log"]
    + [p for name, d in SERIES.items()
       for p in (d, f"{d}/{name}.pvd", f"{d}/{name}000000.vtu",
                 f"{d}/{name}000001.vtu")])


def _tree(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


def _jax_example(out: Path) -> str:
    spec = importlib.util.spec_from_file_location(
        "jax_example_streamer", ROOT / "examples" / "streamer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = dict(vars(jax_files))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(str(out), quick=True, T_final=2e-11)
    finally:
        vars(jax_files).clear()
        vars(jax_files).update(saved)
    return buf.getvalue()


def _port_example(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.examples.streamer", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=600)


def _lines(out: str):
    """Printed lines without the wall time of each Newton solve."""
    return [re.sub(r" \[[0-9.]+s\]$", "", ln) for ln in out.splitlines()]


def test_quick_run_matches_the_jax_example(tmp_path):
    jout = _jax_example(tmp_path / "jax")
    r = _port_example(*ARGS, "--device", "cpu", "-o",
                      str(tmp_path / "port"), cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert _lines(r.stdout) == _lines(jout)
    assert r.stdout.splitlines()[-1] == "Finished: 4 steps (0 rejected)"
    j, t = tmp_path / "jax", tmp_path / "port"
    assert _tree(t) == _tree(j) == TREE
    same = ["model.log", "mesh/mesh.vtu", "mesh/mesh info.txt"]
    same += [f"{d}/{name}.pvd" for name, d in SERIES.items()]
    for f in same:
        assert (t / f).read_bytes() == (j / f).read_bytes(), f
    got, ref = (np.loadtxt(d / "relative error.log") for d in (t, j))
    assert got.shape == ref.shape == (4, 3)
    assert np.array_equal(got[:, 1:], ref[:, 1:])
    np.testing.assert_allclose(got[:, 0], ref[:, 0], rtol=RTOL, atol=0)
    for name, d in SERIES.items():
        for k in range(2):
            f = f"{d}/{name}00000{k}.vtu"
            a, b = read_vtu(t / f, name), read_vtu(j / f, name)
            assert np.array_equal(np.isnan(a), np.isnan(b)), f
            fin = ~np.isnan(b)
            assert fin.any()
            scale = np.abs(b[fin]).max()
            assert np.abs(a[fin] - b[fin]).max() <= RTOL * scale, f


def test_no_cuda_device_means_no_run(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _port_example(*ARGS, "-o", str(tmp_path / "out"), cwd=tmp_path)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert r.stdout == "" and not (tmp_path / "out").exists()


def test_command_line_is_the_jax_examples_plus_device(tmp_path):
    r = _port_example("--help", cwd=tmp_path)
    assert r.returncode == 0
    flags = set(re.findall(r"(--[A-Za-z0-9-]+)", r.stdout))
    assert flags == {"--help", "--output-dir", "--quick", "--f32",
                     "--T-final", "--device"}
