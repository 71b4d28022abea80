"""The port's glow entry point, `python -m
fedm_tpu_torch.examples.glow_discharge --quick --device cpu`, against the
JAX package's `examples/glow_discharge.py --quick` (each on its own
synthetic argon tree, generated the same): the same output tree; the
mesh files, the PVD collection and the XDMF indexes byte for byte; the
model log line for line, its numbers within 1e-11 relative; the same
printed lines but for the tree's path and the wall times, their numbers
within 1e-11 or, where printed to 4 digits (the Newton lines' final
residual norms, set by rounding: 3.880e+05 against 3.879e+05), within
one unit of the last digit; `relative error.log`, every HDF5 dataset, the VTU
series and `checkpoint.npz` within 1e-11 (CPU gaps: times 3.5e-14, the
densities 4.2e-14 of their max). Without a CUDA device the entry point
refuses to run unless told `--device cpu`."""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

import fedm_tpu  # noqa: F401
from fedm_tpu.io import files as jax_files
from fedm_tpu_torch.io import read_vtu

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-11
NAMES = ("Ar_star", "Ar_plus", "electrons")
TREE = sorted(
    ["checkpoint.npz", "mesh", "mesh/mesh info.txt", "mesh/mesh.vtu",
     "model.log", "number density", "potential", "potential/Phi",
     "potential/Phi/Phi.pvd", "potential/Phi/Phi000000.vtu",
     "relative error.log"]
    + [p for n in NAMES for p in (f"number density/{n}",
                                  f"number density/{n}/{n}.h5",
                                  f"number density/{n}/{n}.xdmf")])
NUM = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _tree(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


def _jax_example(out: Path) -> str:
    spec = importlib.util.spec_from_file_location(
        "jax_example_glow", ROOT / "examples" / "glow_discharge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = dict(vars(jax_files))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            mod.main(None, str(out), quick=True)
    finally:
        vars(jax_files).clear()
        vars(jax_files).update(saved)
    return buf.getvalue()


def _port_example(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.examples.glow_discharge",
         *args], capture_output=True, text=True, env=env, cwd=cwd,
        timeout=900)


def _ulp(s: str) -> float:
    """One unit in the last printed digit of the number `s`."""
    m, _, e = s.lower().partition("e")
    decimals = len(m.partition(".")[2])
    return 10.0 ** (int(e or 0) - decimals)


def _same_numbers(a: str, b: str) -> None:
    """Two texts equal but for their numbers, which agree to RTOL or, when
    printed short (the Newton lines' `%.3e` norms), to one unit in their
    last printed digit."""
    assert NUM.sub("#", a) == NUM.sub("#", b)
    for xs, ys in zip(NUM.findall(a), NUM.findall(b)):
        x, y = float(xs), float(ys)
        assert abs(x - y) <= max(RTOL * abs(y), _ulp(ys) * 1.0001), (xs, ys)


def _datasets(path: Path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def _close(a, b) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= RTOL * max(np.abs(b).max(), 1e-300)


def test_quick_run_matches_the_jax_example(tmp_path):
    jout = _jax_example(tmp_path / "jax")
    r = _port_example("--quick", "--device", "cpu", "-o",
                      str(tmp_path / "port"), cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    # past the line naming the generated tree, without the wall times
    lines, jlines = ([re.sub(r" \[[0-9.]+s\]$", "", ln)
                      for ln in out.splitlines()[1:]]
                     for out in (r.stdout, jout))
    _same_numbers("\n".join(lines), "\n".join(jlines))
    assert lines[-1] == ("Finished: 6 steps (0 rejected), checkpoint "
                         "written")
    j, t = tmp_path / "jax", tmp_path / "port"
    assert _tree(t) == _tree(j) == TREE
    same = ["mesh/mesh.vtu", "mesh/mesh info.txt", "potential/Phi/Phi.pvd"]
    same += [f"number density/{n}/{n}.xdmf" for n in NAMES]
    for f in same:
        assert (t / f).read_bytes() == (j / f).read_bytes(), f
    _same_numbers((t / "model.log").read_text(),
                  (j / "model.log").read_text())
    _close(np.loadtxt(t / "relative error.log"),
           np.loadtxt(j / "relative error.log"))
    for n in NAMES:
        f = f"number density/{n}/{n}.h5"
        a, b = _datasets(t / f), _datasets(j / f)
        assert sorted(a) == sorted(b)
        for k in b:
            _close(a[k], b[k])
    f = "potential/Phi/Phi000000.vtu"
    _close(read_vtu(t / f, "Phi"), read_vtu(j / f, "Phi"))
    a, b = np.load(t / "checkpoint.npz"), np.load(j / "checkpoint.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        if k in ("n_accepted", "n_rejected"):
            assert int(a[k]) == int(b[k]) == (6 if k == "n_accepted" else 0)
        else:
            _close(a[k], b[k])


def test_no_cuda_device_means_no_run(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _port_example("--quick", "-o", str(tmp_path / "out"), cwd=tmp_path)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert r.stdout == "" and not (tmp_path / "out").exists()


def test_command_line_is_the_jax_examples_plus_device(tmp_path):
    r = _port_example("--help", cwd=tmp_path)
    assert r.returncode == 0
    flags = set(re.findall(r"(--[A-Za-z0-9-]+)", r.stdout))
    assert flags == {"--help", "--file-input", "--output-dir", "--quick",
                     "--T-final", "--device"}
