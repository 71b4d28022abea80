"""z-line (tridiagonal) solves for anisotropic tensor-product meshes (the
JAX package's `solvers/linesmoother.py`).

Where dz << dr the z-coupling dominates the Laplacian and point smoothing
cannot damp z-oscillatory error: line relaxation solves each z-line's
tridiagonal system exactly, batched over the r-columns. Two batched
tridiagonal solvers:

- `tridiag_solve_batched` (Thomas): 2 * n_z sequential steps, each a tiny
  vector operation — thousands of launches on a GPU; kept for parity, not
  for a timed path;
- `tridiag_solve_pcr` (parallel cyclic reduction): ceil(log2(n_z))
  full-width rounds, the default.

`ZLineSmoother` reads the in-line couplings of any masked operator off
the nine colouring probes of `stencil.coloring_probes`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .stencil import coloring_probes


def tridiag_solve_batched(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                          d: torch.Tensor) -> torch.Tensor:
    """The Thomas algorithm per line, batched over the leading axis; the
    contract of `tridiag_solve_pcr` (a[:, 0] and c[:, -1] ignored)."""
    n = a.shape[1]
    cp = torch.zeros_like(d)
    dp = torch.zeros_like(d)
    cp_prev = dp_prev = torch.zeros(d.shape[0], dtype=d.dtype,
                                    device=d.device)
    for j in range(n):
        denom = b[:, j] - a[:, j] * cp_prev
        cp[:, j] = cp_prev = c[:, j] / denom
        dp[:, j] = dp_prev = (d[:, j] - a[:, j] * dp_prev) / denom
    x = torch.empty_like(d)
    x_next = torch.zeros_like(cp_prev)
    for j in range(n - 1, -1, -1):
        x[:, j] = x_next = dp[:, j] - cp[:, j] * x_next
    return x


def tridiag_solve_pcr(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                      d: torch.Tensor) -> torch.Tensor:
    """Solve per-line tridiagonal systems batched over the leading axis:
    a, b, c, d [n_lines, n] are the sub-, main-, super-diagonal and rhs
    (a[:, 0] and c[:, -1] ignored); d may carry leading right-hand-side
    axes [..., n_lines, n] over the same lines. ceil(log2(n)) rounds, each
    eliminating the neighbours at distance s by row combination:
        alpha_i = -a_i / b_{i-s},  gamma_i = -c_i / b_{i+s}
        b'_i = b_i + alpha_i c_{i-s} + gamma_i a_{i+s}
        d'_i = d_i + alpha_i d_{i-s} + gamma_i d_{i+s}
        a'_i = alpha_i a_{i-s},    c'_i = gamma_i c_{i+s}
    Out-of-range rows act as identity rows. Stable for diagonally dominant
    lines (the masked Laplacian stencils)."""
    n = a.shape[-1]
    a = a.clone()
    c = c.clone()
    a[..., 0] = 0.0
    c[..., -1] = 0.0

    def shift_dn(x, s):  # x_{i-s}, zeros below
        return F.pad(x, (s, 0))[..., :n]

    def shift_up(x, s):  # x_{i+s}, zeros above
        return F.pad(x, (0, s))[..., s:]

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


class ZLineSmoother:
    """Line-Jacobi preconditioner: tridiagonal solves along the j-lines of
    a tensor-product dof grid, with Richardson refinement.

    A: the (masked) linear operator on flat [n_dofs] vectors; node_grid:
    [n_i, n_j] dof ids, each dof once; n_iter: line solves in all (1 is
    plain line-Jacobi, more add x += M(r - A x)); method: 'pcr' (the
    default; unpivoted, for diagonally dominant lines) or 'thomas'.
    """

    METHODS = ("pcr", "thomas")

    def __init__(self, A: Callable, node_grid: np.ndarray, n_dofs: int,
                 n_iter: int = 2, dtype=None, method: str = "pcr", *,
                 device):
        node_grid = np.asarray(node_grid)
        if node_grid.size != n_dofs:
            raise ValueError("node_grid must enumerate every dof exactly "
                             "once")
        if method not in self.METHODS:
            raise ValueError(f"method {method!r}; options are "
                             f"{self.METHODS}")
        self.A = A
        self.n_dofs = n_dofs
        self.n_iter = n_iter
        dtype = torch.float64 if dtype is None else dtype
        dev = torch.device(device)
        self.grid = torch.as_tensor(node_grid, device=dev)
        n_i, n_j = node_grid.shape
        I, J = np.meshgrid(np.arange(n_i), np.arange(n_j), indexing="ij")
        probes, keys = coloring_probes(node_grid, n_dofs)
        diag = np.empty((n_i, n_j))
        sub = np.zeros((n_i, n_j))
        sup = np.zeros((n_i, n_j))
        for p, (ai, bj) in zip(probes, keys):
            y = A(torch.as_tensor(p, dtype=dtype, device=dev))
            y = y.cpu().numpy()[node_grid]
            sel_d = (I % 3 == ai) & (J % 3 == bj)
            diag[sel_d] = y[sel_d]
            sel_s = (I % 3 == ai) & ((J - 1) % 3 == bj)  # neighbour j-1
            sub[sel_s] = y[sel_s]
            sel_u = (I % 3 == ai) & ((J + 1) % 3 == bj)  # neighbour j+1
            sup[sel_u] = y[sel_u]
        sub[:, 0] = 0.0
        sup[:, -1] = 0.0
        self._a, self._b, self._c = (
            torch.as_tensor(v, dtype=dtype, device=dev)
            for v in (sub, diag, sup))
        self._solve = {"pcr": tridiag_solve_pcr,
                       "thomas": tridiag_solve_batched}[method]

    def _line_solve(self, r: torch.Tensor) -> torch.Tensor:
        xg = self._solve(self._a, self._b, self._c,
                         r[self.grid].to(self._b.dtype))
        out = torch.zeros(self.n_dofs, dtype=xg.dtype, device=xg.device)
        out[self.grid.reshape(-1)] = xg.reshape(-1)
        return out

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        """Approximate A^-1 r (the elliptic-row preconditioner)."""
        x = self._line_solve(r)
        for _ in range(self.n_iter - 1):
            x = x + self._line_solve(r - self.A(x).to(r.dtype))
        return x
