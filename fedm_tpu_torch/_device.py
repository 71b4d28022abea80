"""Device selection shared by the package's entry points."""

from __future__ import annotations

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
