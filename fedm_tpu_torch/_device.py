"""Device selection shared by the package's entry points."""

from __future__ import annotations

import sys

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `device` as a `torch.device`, and on a CUDA device keep float32
    matrix products and convolutions in full float32 (no TF32) — the
    counterpart of the JAX package's forced `highest` matmul precision."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def check_device(device) -> None:
    """Stop with an error, before any work, when `device` is a CUDA device
    and none is present: the entry points never fall back to the CPU."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"no CUDA device for --device {device}; pass --device cpu "
                 "to run on the CPU")
