"""Upwind (artificial-diffusion) stabilisation for drift-dominated fronts,
the JAX package's `ops/stabilization.py`: a pointwise change of the
diffusion coefficient at quadrature points,

  linear:  D <- D + c * 0.5 * |v| * h_v
  peclet:  D <- max(D, c * 0.5 * |v| * h_v)

with `h_v` the cell size along the drift velocity (v ~ E):
h_v = (|E| . extents) / |E| per quadrature point. At a tie of `peclet`'s
maximum the tangent is the mean of both sides' (torch.maximum's forward
derivative, as jnp.maximum's), so the Jacobian action agrees with the JAX
package's there too.
"""

from __future__ import annotations

import torch

MODES = ("off", "linear", "peclet")


def directional_h(E_q: torch.Tensor, E_m: torch.Tensor,
                  extents: torch.Tensor) -> torch.Tensor:
    """Cell size along the field: E_q [c, q, dim], E_m [c, q] (floored
    magnitudes), extents [c, dim] per-cell bounding-box extents ->
    [c, q]."""
    return torch.einsum("cqd,cd->cq", E_q.abs(), extents) / E_m


def upwind_diffusion(D_q: torch.Tensor, speed_q: torch.Tensor,
                     h_v: torch.Tensor, mode: str = "peclet",
                     coeff: float = 1.0) -> torch.Tensor:
    """Stabilised diffusion coefficient at quadrature points: D_q the
    physical one, speed_q the drift speed mu*|E|, h_v the directional
    cell size, all [c, q]; `mode` one of MODES."""
    if mode == "off" or coeff == 0.0:
        return D_q
    D_art = coeff * 0.5 * speed_q * h_v
    if mode == "linear":
        return D_q + D_art
    if mode == "peclet":
        return torch.maximum(D_q, D_art)
    raise ValueError(f"unknown stabilisation mode {mode!r}; options are "
                     f"{MODES}")
