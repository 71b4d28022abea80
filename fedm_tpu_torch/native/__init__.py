"""Host-side native components (C++ through ctypes) with numpy/scipy
fallbacks: the port's own copy of the JAX package's `native` module.

`csrc/fedm_native.cpp` is built with g++ at first use (the JAX package's
command line, `g++ -O3 -shared -fPIC -std=c++17`) into the gitignored
`fedm_tpu_torch/_build/`, under a name keyed by a hash of the source and
the flags; a finished build is renamed into place, so concurrent first uses
never load a partial file. Where no compiler is present, every entry point
falls back to the JAX package's numpy/scipy version.

- `rcm_order`: reverse Cuthill-McKee, the dof-locality renumbering of
  `mesh.reorder.rcm_reorder`;
- `partition_graph`: the greedy graph-growing partitioner of the
  DOF-partitioned domain decomposition (`parallel.dd`). It is
  deterministic: the same CSR gives the same parts as the JAX package's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE / "csrc" / "fedm_native.cpp"
BUILD_DIR = _PACKAGE / "_build"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_build_failed = False


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"fedm_native_{key[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        _build_failed = True
        return None
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rcm_order.argtypes = [ctypes.c_int, ip, ip, ip]
    lib.rcm_order.restype = None
    lib.partition_graph.argtypes = [ctypes.c_int, ip, ip, ctypes.c_int, ip]
    lib.partition_graph.restype = None
    _lib = lib
    return _lib


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _csr(rowptr, colidx):
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int32)
    colidx = np.ascontiguousarray(colidx, dtype=np.int32)
    n = len(rowptr) - 1
    if n < 0 or int(rowptr[0]) != 0 or int(rowptr[-1]) != len(colidx) \
            or np.any(np.diff(rowptr) < 0):
        raise ValueError("not a CSR graph: rowptr must start at 0, not "
                         "decrease and end at len(colidx)")
    if len(colidx) and (colidx.min() < 0 or colidx.max() >= n):
        raise ValueError(f"colidx out of [0, {n})")
    return n, rowptr, colidx


def native_available() -> bool:
    return _load() is not None


def rcm_order(rowptr: np.ndarray, colidx: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a CSR adjacency; returns perm
    (int32) with perm[new] = old."""
    n, rowptr, colidx = _csr(rowptr, colidx)
    lib = _load()
    if lib is not None:
        perm = np.empty(n, dtype=np.int32)
        lib.rcm_order(n, _iptr(rowptr), _iptr(colidx), _iptr(perm))
        return perm
    # fallback: scipy
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = csr_matrix((np.ones(len(colidx)), colidx, rowptr), shape=(n, n))
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True),
                      dtype=np.int32)


def partition_graph(rowptr: np.ndarray, colidx: np.ndarray,
                    n_parts: int) -> np.ndarray:
    """Balanced greedy graph-growing partition of a CSR graph.

    Returns part[n] (int32) in [0, n_parts) with part sizes differing by at
    most one; parts are grown breadth-first with a max-gain frontier so
    boundaries (the halo traffic of the domain decomposition) stay short.
    """
    n, rowptr, colidx = _csr(rowptr, colidx)
    if n_parts <= 1:
        return np.zeros(n, dtype=np.int32)
    lib = _load()
    if lib is not None:
        part = np.empty(n, dtype=np.int32)
        lib.partition_graph(n, _iptr(rowptr), _iptr(colidx), int(n_parts),
                            _iptr(part))
        return part
    # fallback: contiguous slabs of the RCM ordering (connected, balanced,
    # slightly longer boundaries than the gain-driven C++ growth)
    perm = rcm_order(rowptr, colidx)  # perm[new] = old
    part = np.empty(n, dtype=np.int32)
    sizes = np.full(n_parts, n // n_parts, dtype=np.int64)
    sizes[: n % n_parts] += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    for p in range(n_parts):
        part[perm[bounds[p]:bounds[p + 1]]] = p
    return part
