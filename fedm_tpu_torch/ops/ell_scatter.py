"""ELL gather-sum, the port of the TPU kernel `pallas_ell_scatter`
(fedm_tpu/ops/pallas_scatter.py), in two forms:

- `ell_scatter(flat, idx)`: ``out[d] = sum_v flat[idx[d, v]]`` for every
  row d of the table, into a new tensor (what the TPU kernel computes);
- `ell_scatter_add_(out, flat, idx, rows)`:
  ``out[rows[r]] += sum_v flat[idx[r, v]]``, in place, for the rows of a
  table compacted to the destinations that receive a contribution
  (`rows=None`: row r is destination r). `rows` holds no duplicates.

`idx [n_rows, max_val]` int32 lists the rows of `flat [n_flat, ...]` that
sum into each destination; entries outside [0, n_flat) (the padding
sentinel `n_flat`) contribute zero. Each row's sum starts from zero and adds
the slots in order, and only then meets `out`. All trailing dims of `flat`
are summed in one launch. On the card `idx`, `rows`, `flat` and `out` are
contiguous (row-major, as the batches keep them), and each launch runs on
their device (made current for the launch) and that device's current
stream, whichever device the calling thread had current.

On a CUDA tensor each form launches the hand-written kernel
`csrc/ell_scatter.cu` (built with nvcc at first use) or raises; on CPU
tensors it computes its plain PyTorch version (`ell_scatter_ref`,
`ell_scatter_add_ref`). `LAUNCHES` counts kernel launches by (wrapper,
table, C, dtype), where the table is "dense" when it has a row for every
destination (`ell_scatter`, or `ell_scatter_add_` with `rows=None`: the
unstructured cell scatter) and "compact" when it lists live rows;
`launch_count(wrapper)` sums it.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

SOURCE = "ell_scatter.cu"
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# kernel launches by (wrapper, table, C, dtype); see the module docstring
LAUNCHES: collections.Counter = collections.Counter()


def launch_count(wrapper: str | None = None) -> int:
    """Kernel launches counted in `LAUNCHES`: of one wrapper
    ("ell_scatter" or "ell_scatter_add_"), or of both."""
    return sum(n for key, n in LAUNCHES.items()
               if wrapper is None or key[0] == wrapper)


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load(SOURCE)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # (idx, [rows,] flat, out, n_rows, max_val, n_flat, C, stream); every
    # pointer and the stream as c_void_p
    dense = [p, p, p, ll, i, ll, i, p]
    signatures = {"ell_noop": [ll, i, i, p]}
    for s in _SUFFIX.values():
        signatures[f"ell_scatter_{s}"] = dense
        signatures[f"ell_scatter_add_{s}"] = [p] + dense
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def ell_scatter_ref(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: append a zero row, gather, sum over the valence."""
    n_flat, trailing = flat.shape[0], tuple(flat.shape[1:])
    f2 = flat.reshape(n_flat, -1)
    padded = torch.cat([f2, f2.new_zeros((1, f2.shape[1]))], dim=0)
    safe = torch.where((idx >= 0) & (idx < n_flat), idx, n_flat).long()
    return padded[safe].sum(dim=1).reshape((idx.shape[0],) + trailing)


def ell_scatter_add_ref(out: torch.Tensor, flat: torch.Tensor,
                        idx: torch.Tensor,
                        rows: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of `ell_scatter_add_`: the row sums, then one add."""
    s = ell_scatter_ref(flat, idx)
    if rows is None:
        out += s
    else:
        out[rows.long()] += s
    return out


def _check_table(idx: torch.Tensor) -> None:
    if idx.dim() != 2:
        raise ValueError(f"idx must be [n_rows, max_val], got "
                         f"{tuple(idx.shape)}")


def _kernel_args(name: str, flat: torch.Tensor, idx: torch.Tensor,
                 *others: torch.Tensor):
    """Check what the kernel takes; return its C function."""
    devices = {t.device for t in (flat, idx, *others)}
    if len(devices) != 1 or flat.device.type != "cuda":
        raise ValueError(f"{name} needs all tensors on one CUDA device (got "
                         f"{sorted(map(str, devices))})")
    if flat.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32 or float64, not {flat.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")
    if not (idx.is_contiguous() and flat.is_contiguous()):
        raise ValueError(f"{name} needs a contiguous idx and flat")
    return getattr(_lib(), f"{name}_{_SUFFIX[flat.dtype]}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ell_scatter(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_table(idx)
    if flat.device.type == "cpu" and idx.device.type == "cpu":
        return ell_scatter_ref(flat, idx)
    fn = _kernel_args("ell_scatter", flat, idx)
    n_rows, max_val = idx.shape
    out = torch.empty((n_rows,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    if n_rows and out.numel():
        with torch.cuda.device(flat.device):
            _raise_on(fn(idx.data_ptr(), flat.data_ptr(), out.data_ptr(),
                         n_rows, max_val, flat.shape[0],
                         math.prod(flat.shape[1:]), _stream(flat)),
                      "ell_scatter")
        LAUNCHES["ell_scatter", "dense", math.prod(flat.shape[1:]),
                 _SUFFIX[flat.dtype]] += 1
    return out


def ell_scatter_add_(out: torch.Tensor, flat: torch.Tensor,
                     idx: torch.Tensor,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    _check_table(idx)
    n_rows, max_val = idx.shape
    if rows is not None and tuple(rows.shape) != (n_rows,):
        raise ValueError(f"rows must be [{n_rows}], got {tuple(rows.shape)}")
    if rows is None and out.shape[0] != n_rows:
        raise ValueError(f"without rows, out needs {n_rows} rows, not "
                         f"{out.shape[0]}")
    if out.shape[1:] != flat.shape[1:]:
        raise ValueError(f"out {tuple(out.shape)} and flat "
                         f"{tuple(flat.shape)} differ in their trailing dims")
    if out.dtype != flat.dtype:
        raise TypeError(f"out is {out.dtype} but flat is {flat.dtype}")
    if out.requires_grad:
        raise ValueError("ell_scatter_add_ writes into out in place; out "
                         "must not require grad")
    tables = (idx,) if rows is None else (idx, rows)
    if all(t.device.type == "cpu" for t in (out, flat, *tables)):
        return ell_scatter_add_ref(out, flat, idx, rows)
    fn = _kernel_args("ell_scatter_add", flat, idx, out, *tables[1:])
    if rows is not None and rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, not {rows.dtype}")
    if not (out.is_contiguous() and (rows is None or rows.is_contiguous())):
        raise ValueError("ell_scatter_add_ needs a contiguous out and rows")
    if n_rows and out.numel():
        with torch.cuda.device(flat.device):
            _raise_on(fn(idx.data_ptr(),
                         None if rows is None else rows.data_ptr(),
                         flat.data_ptr(), out.data_ptr(), n_rows, max_val,
                         flat.shape[0], math.prod(flat.shape[1:]),
                         _stream(flat)), "ell_scatter_add_")
        LAUNCHES["ell_scatter_add_", "dense" if rows is None else "compact",
                 math.prod(flat.shape[1:]), _SUFFIX[flat.dtype]] += 1
    return out


def ell_noop(n_rows: int, max_val: int, C: int, device="cuda") -> None:
    """Launch the empty kernel of `csrc/ell_scatter.cu` on the grid of a call
    over `n_rows` rows of `max_val` slots and `C` components (the floor that
    chip_smoke.py times)."""
    _raise_on(_lib().ell_noop(n_rows, max_val, C,
                              torch.cuda.current_stream(device).cuda_stream),
              "ell_noop")

