"""Look-up-table interpolation on the device with `np.interp` semantics
(the JAX package's `ops/interp.py`, which calls `jnp.interp`): linear
between the knots, exact at them, constant `fp[0]` / `fp[-1]` outside the
table. Torch has no `interp`; this follows `jnp.interp` step for step
(`searchsorted` on the right, the bracket clipped into the table, a
zero-width bracket taking its left value)."""

from __future__ import annotations

import numpy as np
import torch

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def lut_interp(x: torch.Tensor, xp: torch.Tensor,
               fp: torch.Tensor) -> torch.Tensor:
    """f(x) for the table (xp ascending, fp), elementwise over `x` of any
    shape. `x` and `xp` meet in their promoted type, as in `jnp.interp`."""
    dt = torch.promote_types(x.dtype, xp.dtype)
    shape = x.shape
    x, xp = x.to(dt).reshape(-1), xp.to(dt)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1,
                    xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    ftype = _NP[dt]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(ftype).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f).reshape(shape)
