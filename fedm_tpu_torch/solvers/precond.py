"""Node-block Jacobi preconditioner pieces: closed-form inversion of the
per-node 3x3 Jacobian blocks and their application."""

from __future__ import annotations

import torch


def invert_blocks(A: torch.Tensor, with_count: bool = False):
    """Invert a batch of 3x3 matrices A [n, 3, 3] by adjugate, after
    per-row equilibration (inv(A) = inv(D^-1 A) D^-1 with D the row maxima,
    so the cofactor products stay O(1) whatever the rows' physical scale).
    Blocks whose inverse comes out non-finite (a structurally singular
    block, e.g. an underflowed log-density column) fall back to the
    diagonal pseudo-inverse, with unit action on dead rows. `with_count`
    also returns how many blocks took that fallback."""
    if A.shape[-1] != 3:
        raise NotImplementedError("invert_blocks is ported for 3x3 blocks")
    A_orig = A
    s = A.abs().amax(dim=-1, keepdim=True)  # [n, 3, 1] row maxima
    s = torch.where((s > 0) & torch.isfinite(s), s, 1.0)
    a = A / s
    s = s.transpose(-2, -1)  # inverse columns j scale by 1/row_max_j
    c00 = a[:, 1, 1] * a[:, 2, 2] - a[:, 1, 2] * a[:, 2, 1]
    c01 = a[:, 1, 2] * a[:, 2, 0] - a[:, 1, 0] * a[:, 2, 2]
    c02 = a[:, 1, 0] * a[:, 2, 1] - a[:, 1, 1] * a[:, 2, 0]
    c10 = a[:, 0, 2] * a[:, 2, 1] - a[:, 0, 1] * a[:, 2, 2]
    c11 = a[:, 0, 0] * a[:, 2, 2] - a[:, 0, 2] * a[:, 2, 0]
    c12 = a[:, 0, 1] * a[:, 2, 0] - a[:, 0, 0] * a[:, 2, 1]
    c20 = a[:, 0, 1] * a[:, 1, 2] - a[:, 0, 2] * a[:, 1, 1]
    c21 = a[:, 0, 2] * a[:, 1, 0] - a[:, 0, 0] * a[:, 1, 2]
    c22 = a[:, 0, 0] * a[:, 1, 1] - a[:, 0, 1] * a[:, 1, 0]
    det = a[:, 0, 0] * c00 + a[:, 0, 1] * c01 + a[:, 0, 2] * c02
    adj = torch.stack([torch.stack([c00, c10, c20], -1),
                       torch.stack([c01, c11, c21], -1),
                       torch.stack([c02, c12, c22], -1)], -2)
    inv = adj / det[:, None, None] / s

    ok = torch.isfinite(inv).all(dim=-1, keepdim=True).all(dim=-2,
                                                           keepdim=True)
    d = torch.diagonal(A_orig, dim1=-2, dim2=-1)
    dinv = torch.where((d.abs() > 0) & torch.isfinite(d), 1.0 / d, 1.0)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    out = torch.where(ok, inv, dinv[..., :, None] * eye)
    if with_count:
        return out, int((~ok).sum())
    return out


def block_apply(inv_blocks: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r for block-diagonal M: [n, k, k] x [n, k] -> [n, k]."""
    return torch.einsum("nij,nj->ni", inv_blocks, r)
