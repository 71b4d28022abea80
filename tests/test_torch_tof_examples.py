"""The port's time-of-flight entry points, `python -m
fedm_tpu_torch.examples.tof_1d` and `.tof_2d`, run with `--quick --device
cpu` against the JAX package's `examples/tof_1d.py` and `tof_2d.py` run
with `--quick`: the same output tree, the same printed lines, the model
log, mesh files and PVD collections byte for byte, and the relative L2
errors and densities to 1e-11 relative (the two packages' states agree to
rounding; the error metric's CG stops at 1e-12). Without a CUDA device
the entry points refuse to run unless told `--device cpu`."""

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
TREE = sorted([
    "mesh", "mesh/mesh info.txt", "mesh/mesh.vtu", "model.log",
    "number density", "number density/analytical solution",
    "number density/analytical solution/analytical solution.pvd",
    "number density/analytical solution/analytical solution000000.vtu",
    "number density/electrons", "number density/electrons/electrons.pvd",
    "number density/electrons/electrons000000.vtu", "relative error.log"])


def _tree(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


def _jax_example(name, out: Path) -> str:
    """examples/<name>.py --quick -o out, in this process; returns its
    stdout. The JAX package's `files` singleton is restored after."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = dict(vars(jax_files))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(str(out), quick=True)
    finally:
        vars(jax_files).clear()
        vars(jax_files).update(saved)
    return buf.getvalue()


def _port_example(name, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", f"fedm_tpu_torch.examples.{name}", *args],
        capture_output=True, text=True, env=env, cwd=cwd, timeout=600)


def _error_lines(path: Path):
    pat = re.compile(r"h_max = (\S+)\t dt = (\S+)\t relative_error = (\S+)")
    rows = [pat.fullmatch(line).groups()
            for line in path.read_text().splitlines()]
    return [(h, dt, float(e)) for h, dt, e in rows]


@pytest.mark.parametrize("name,n_errors", [("tof_1d", 3), ("tof_2d", 1)])
def test_quick_run_matches_the_jax_example(tmp_path, name, n_errors):
    jout = _jax_example(name, tmp_path / "jax")
    r = _port_example(name, "--quick", "--device", "cpu", "-o",
                      str(tmp_path / "port"), cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == jout
    j, t = tmp_path / "jax", tmp_path / "port"
    assert _tree(t) == _tree(j) == TREE
    for f in ("model.log", "mesh/mesh.vtu", "mesh/mesh info.txt",
              "number density/electrons/electrons.pvd",
              "number density/analytical solution/"
              "analytical solution.pvd"):
        assert (t / f).read_bytes() == (j / f).read_bytes(), f
    got, ref = (_error_lines(d / "relative error.log") for d in (t, j))
    assert len(got) == len(ref) == n_errors
    for (h, dt, e), (jh, jdt, je) in zip(got, ref):
        assert (h, dt) == (jh, jdt)
        assert abs(e - je) / je <= RTOL
    for series in ("electrons", "analytical solution"):
        f = f"number density/{series}/{series}000000.vtu"
        a, b = read_vtu(t / f, series), read_vtu(j / f, series)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", ["tof_1d", "tof_2d"])
def test_no_cuda_device_means_no_run(tmp_path, name):
    """The default device is cuda; without one the entry point exits non-zero
    before it writes anything, and never runs on the CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _port_example(name, "--quick", "-o", str(tmp_path / "out"),
                      cwd=tmp_path)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert r.stdout == "" and not (tmp_path / "out").exists()


def test_command_line_is_the_jax_examples_plus_device(tmp_path):
    r = _port_example("tof_1d", "--help", cwd=tmp_path)
    assert r.returncode == 0
    flags = set(re.findall(r"(--[a-z-]+)", r.stdout))
    assert flags == {"--help", "--output-dir", "--quick", "--device"}
