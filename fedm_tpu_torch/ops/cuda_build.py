"""Build a CUDA source of `csrc/` into a shared library with nvcc, at first
use, and load it with ctypes.

The source has a plain C interface (no PyTorch headers), so one nvcc call
takes seconds. The library lands in `fedm_tpu_torch/_build/` under a name
keyed by a hash of the source and the flags: a changed source builds anew,
an unchanged one loads the library already there. A finished build is
renamed into place, so concurrent first uses never load a partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "fedm_tpu_torch are built from source at first use")


def library_path(source: str) -> Path:
    src = (CSRC / source).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}_{key[:16]}.so"


def build(source: str, timeout: float = 600.0) -> tuple:
    """Compile `csrc/<source>` unless its library is already built.
    Returns (library path, nvcc's output or '' when nothing was built)."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    path, _ = build(source)
    return ctypes.CDLL(str(path))
