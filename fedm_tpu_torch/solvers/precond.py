"""Node-block Jacobi preconditioner pieces: inversion of the per-node
k x k Jacobian blocks and their application (the JAX package's
`solvers/precond.py`): closed forms for k <= 3, an unrolled Gauss-Jordan
with partial pivoting for k > 3."""

from __future__ import annotations

import torch


def _guard(inv: torch.Tensor, A: torch.Tensor, with_count: bool):
    """Blocks whose inverse comes out non-finite (a structurally singular
    block, e.g. an underflowed log-density column) fall back to the
    diagonal pseudo-inverse of `A`, with unit action on dead rows."""
    k = A.shape[-1]
    ok = torch.isfinite(inv).all(dim=-1, keepdim=True).all(dim=-2,
                                                           keepdim=True)
    d = torch.diagonal(A, dim1=-2, dim2=-1)
    dinv = torch.where((d.abs() > 0) & torch.isfinite(d), 1.0 / d, 1.0)
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    out = torch.where(ok, inv, dinv[..., :, None] * eye)
    if with_count:
        return out, int((~ok).sum())
    return out


def invert_blocks(A: torch.Tensor, reg: float = 0.0,
                  with_count: bool = False):
    """Invert a batch of small matrices A [n, k, k].

    `reg`: a Tikhonov diagonal added first (reg * I; guards against exactly
    singular blocks). Rows are equilibrated first (inv(A) = inv(D^-1 A)
    D^-1 with D the row maxima), so the cofactor products and eliminations
    stay O(1) whatever the rows' physical scale. `with_count` also returns
    how many blocks took the Jacobi fallback of `_guard`."""
    k = A.shape[-1]
    if reg:
        A = A + reg * torch.eye(k, dtype=A.dtype, device=A.device)
    A_orig = A
    s = A.abs().amax(dim=-1, keepdim=True)  # [n, k, 1] row maxima
    s = torch.where((s > 0) & torch.isfinite(s), s, 1.0)
    A = A / s
    s = s.transpose(-2, -1)  # inverse columns j scale by 1/row_max_j
    if k == 1:
        return _guard((1.0 / A) / s, A_orig, with_count)
    if k == 2:
        a, b = A[:, 0, 0], A[:, 0, 1]
        c, d = A[:, 1, 0], A[:, 1, 1]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], -1),
                           torch.stack([-c, a], -1)], -2)
        return _guard(inv / det[:, None, None] / s, A_orig, with_count)
    if k == 3:
        a = A
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
        return _guard(adj / det[:, None, None] / s, A_orig, with_count)

    # k > 3: Gauss-Jordan on [A | I] with partial pivoting, unrolled over
    # the columns; the pivot is the first row of largest magnitude at or
    # below the diagonal, as `jnp.argmax` picks it
    n = A.shape[0]
    M = torch.cat([A, torch.eye(k, dtype=A.dtype,
                                device=A.device).expand(n, k, k)], dim=-1)
    rows = torch.arange(n, device=A.device)
    for col in range(k):
        p = col + torch.argmax(M[:, col:, col].abs(), dim=1)
        pivot_row = M[rows, p]  # [n, 2k], a copy
        M[rows, p] = M[:, col].clone()
        M[:, col] = pivot_row / pivot_row[:, col:col + 1]
        factors = M[:, :, col].clone()
        factors[:, col] = 0.0
        M = M - factors[:, :, None] * M[:, col][:, None, :]
    return _guard(M[:, :, k:] / s, A_orig, with_count)


def block_apply(inv_blocks: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r for block-diagonal M: [n, k, k] x [n, k] -> [n, k]."""
    return torch.einsum("nij,nj->ni", inv_blocks, r)
