"""Batched tridiagonal line solves by parallel cyclic reduction (PCR)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def tridiag_solve_pcr(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """Solve per-line tridiagonal systems batched over the leading axis:
    a, b, c, d [n_lines, n] are the sub-, main-, super-diagonal and rhs
    (a[:, 0] and c[:, -1] ignored). ceil(log2(n)) rounds, each eliminating
    the neighbours at distance s by row combination:
        alpha_i = -a_i / b_{i-s},  gamma_i = -c_i / b_{i+s}
        b'_i = b_i + alpha_i c_{i-s} + gamma_i a_{i+s}
        d'_i = d_i + alpha_i d_{i-s} + gamma_i d_{i+s}
        a'_i = alpha_i a_{i-s},    c'_i = gamma_i c_{i+s}
    Out-of-range rows act as identity rows. Stable for diagonally dominant
    lines (the masked Laplacian stencils)."""
    n = a.shape[1]
    a = a.clone()
    c = c.clone()
    a[:, 0] = 0.0
    c[:, -1] = 0.0

    def shift_dn(x, s):  # x_{i-s}, zeros below
        return F.pad(x, (s, 0))[:, :n]

    def shift_up(x, s):  # x_{i+s}, zeros above
        return F.pad(x, (0, s))[:, s:]

    s = 1
    while s < n:
        bm, bp = shift_dn(b, s), shift_up(b, s)
        # out-of-range neighbours are identity rows whose a/c are already
        # zero: guard only against 0/0
        alpha = -a / torch.where(bm == 0, 1.0, bm)
        gamma = -c / torch.where(bp == 0, 1.0, bp)
        b = b + alpha * shift_dn(c, s) + gamma * shift_up(a, s)
        d = d + alpha * shift_dn(d, s) + gamma * shift_up(d, s)
        a = alpha * shift_dn(a, s)
        c = gamma * shift_up(c, s)
        s *= 2
    return d / b
