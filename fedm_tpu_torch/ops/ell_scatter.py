"""ELL gather-sum, the port of the TPU kernel `pallas_ell_scatter`
(fedm_tpu/ops/pallas_scatter.py): ``out[d] = sum_v flat[idx[d, v]]``.

`idx [n_dofs, max_val]` int32 lists, per destination dof, the rows of
`flat [n_flat, ...]` that sum into it; entries outside [0, n_flat) (the
padding sentinel `n_flat`) contribute zero. All trailing dims of `flat` are
summed in one launch.

On a CUDA tensor `ell_scatter` launches the hand-written kernel
`csrc/ell_scatter.cu` (built with nvcc at first use) or raises; on a CPU
tensor it computes the plain PyTorch version `ell_scatter_ref`.
`ell_scatter.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

SOURCE = "ell_scatter.cu"


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load(SOURCE)
    for fn in (lib.ell_scatter_f32, lib.ell_scatter_f64):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def ell_scatter_ref(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: append a zero row, gather, sum over the valence."""
    n_flat, trailing = flat.shape[0], tuple(flat.shape[1:])
    f2 = flat.reshape(n_flat, -1)
    padded = torch.cat([f2, f2.new_zeros((1, f2.shape[1]))], dim=0)
    safe = torch.where((idx >= 0) & (idx < n_flat), idx, n_flat).long()
    return padded[safe].sum(dim=1).reshape((idx.shape[0],) + trailing)


def ell_scatter(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if idx.dim() != 2:
        raise ValueError(f"idx must be [n_dofs, max_val], got {tuple(idx.shape)}")
    if flat.device.type == "cpu" and idx.device.type == "cpu":
        return ell_scatter_ref(flat, idx)
    if flat.device.type != "cuda" or idx.device != flat.device:
        raise ValueError(f"ell_scatter needs flat and idx on one CUDA device "
                         f"(got {flat.device} and {idx.device})")
    if flat.dtype == torch.float32:
        fn = _lib().ell_scatter_f32
    elif flat.dtype == torch.float64:
        fn = _lib().ell_scatter_f64
    else:
        raise TypeError(f"ell_scatter takes float32 or float64, not {flat.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, not {idx.dtype}")
    if not (flat.is_contiguous() and idx.is_contiguous()):
        raise ValueError("ell_scatter needs contiguous flat and idx")
    n_dofs, max_val = idx.shape
    C = math.prod(flat.shape[1:])
    out = torch.empty((n_dofs,) + tuple(flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    err = fn(idx.data_ptr(), flat.data_ptr(), out.data_ptr(), n_dofs,
             max_val, flat.shape[0], C, stream)
    if err != 0:
        raise RuntimeError(f"ell_scatter kernel launch failed: CUDA error {err}")
    ell_scatter.launches += 1
    return out


ell_scatter.launches = 0
