"""The 9-point stencil form of a scalar operator on a tensor-product node
grid (the JAX package's `solvers/stencil.py`).

On a canonical 'right' rectangle mesh the masked P1 Laplacian is exactly a
9-point stencil, and its matvec is nine shifted multiply-adds on the
[n_i, n_j] node grid, with no gathers. The stencil is read off any masked
linear operator by nine 3-colouring probe matvecs: a (i mod 3, j mod 3)
colouring attributes every response within the 9-neighbourhood uniquely.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def canonical_node_grid(space):
    """[n_i, n_j] node-id grid of a P1 space on a tensor-product mesh in the
    canonical `id = j * n_i + i` layout, or None if the space is not of that
    form."""
    c = np.asarray(space.dof_coords)
    xs, zs = np.unique(c[:, 0]), np.unique(c[:, 1])
    if len(xs) * len(zs) != space.n_dofs:
        return None
    ix = np.searchsorted(xs, c[:, 0])
    iz = np.searchsorted(zs, c[:, 1])
    if not np.array_equal(iz * len(xs) + ix, np.arange(space.n_dofs)):
        return None
    I, J = np.meshgrid(np.arange(len(xs)), np.arange(len(zs)),
                       indexing="ij")
    return J * len(xs) + I


def stencil_matvec(S: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """9-point stencil matvec in grid layout: X, result [..., n_i, n_j]
    (leading dims are independent right-hand sides)."""
    n_i, n_j = X.shape[-2:]
    P = F.pad(X, (1, 1, 1, 1))
    out = torch.zeros_like(X)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            out = out + S[di + 1, dj + 1] * P[..., 1 + di:1 + di + n_i,
                                              1 + dj:1 + dj + n_j]
    return out


def coloring_probes(node_grid: np.ndarray, n_dofs: int):
    """The nine (i mod 3, j mod 3) colouring probes [9, n_dofs] (float64
    numpy) and their keys (i mod 3, j mod 3), in probe order."""
    n_i, n_j = node_grid.shape
    I, J = np.meshgrid(np.arange(n_i), np.arange(n_j), indexing="ij")
    probes = np.zeros((9, n_dofs))
    keys = []
    for ai in range(3):
        for bj in range(3):
            sel = (I % 3 == ai) & (J % 3 == bj)
            probes[len(keys), node_grid[sel]] = 1.0
            keys.append((ai, bj))
    return probes, keys


class StencilOp:
    """y = A x for a scalar operator whose sparsity lies within the
    (i±1, j±1) neighbourhood of a tensor-product node grid.

    node_grid: [n_i, n_j] dof ids, each dof exactly once. On the canonical
    `id = j * n_i + i` layout grid <-> flat is a reshape and transpose,
    otherwise a gather and a scatter. Dirichlet masking is inherited from
    the probed operator (identity rows come out as diag 1, neighbours 0).
    `validate` checks the stencil against A on a seeded vector and raises
    ValueError when the operator reaches beyond the 9-neighbourhood.
    """

    def __init__(self, A: Callable, node_grid: np.ndarray, n_dofs: int,
                 dtype=None, validate: bool = True, *, device):
        node_grid = np.asarray(node_grid)
        if node_grid.size != n_dofs:
            raise ValueError("node_grid must enumerate every dof exactly "
                             "once")
        n_i, n_j = node_grid.shape
        self.n_i, self.n_j, self.n_dofs = n_i, n_j, n_dofs
        self.dtype = torch.float64 if dtype is None else dtype
        self.device = torch.device(device)
        I, J = np.meshgrid(np.arange(n_i), np.arange(n_j), indexing="ij")
        self._reshape_ok = bool(np.array_equal(node_grid, J * n_i + I))
        self._grid = (None if self._reshape_ok
                      else torch.as_tensor(node_grid, device=self.device))

        probes, keys = coloring_probes(node_grid, n_dofs)
        resp = {}
        for p, k in zip(probes, keys):
            y = A(torch.as_tensor(p, dtype=self.dtype, device=self.device))
            resp[k] = y.cpu().numpy()[node_grid]

        # S[di+1][dj+1][i, j] multiplies x[i+di, j+dj]; neighbour
        # (i+di, j+dj) was lit by the probe of its own colour
        S = np.zeros((3, 3, n_i, n_j))
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for ai in range(3):
                    for bj in range(3):
                        m = ((I + di) % 3 == ai) & ((J + dj) % 3 == bj)
                        S[di + 1, dj + 1][m] = resp[(ai, bj)][m]
        # out-of-range neighbours contribute nothing
        S[0, :, 0, :] = 0.0
        S[2, :, -1, :] = 0.0
        S[:, 0, :, 0] = 0.0
        S[:, 2, :, -1] = 0.0
        self._S = torch.as_tensor(S, dtype=self.dtype, device=self.device)

        if validate:
            x = np.random.default_rng(0).standard_normal(n_dofs)
            xt = torch.as_tensor(x, dtype=self.dtype, device=self.device)
            y_ref = A(xt).cpu().numpy().astype(np.float64)
            y_st = self.apply(xt).cpu().numpy().astype(np.float64)
            scale = max(np.abs(y_ref).max(), 1e-30)
            err = np.abs(y_st - y_ref).max() / scale
            tol = 1e-4 if self.dtype == torch.float32 else 1e-9
            if not err < tol:
                raise ValueError(
                    f"stencil extraction mismatch (rel {err:.2e}): the "
                    f"operator reaches beyond the 9-point neighbourhood of "
                    f"node_grid")

    # -- layout -------------------------------------------------------------

    def to_grid(self, x: torch.Tensor) -> torch.Tensor:
        if self._reshape_ok:
            return x.reshape(self.n_j, self.n_i).T
        return x[self._grid]

    def to_flat(self, X: torch.Tensor) -> torch.Tensor:
        if self._reshape_ok:
            return X.T.reshape(-1)
        out = torch.zeros(self.n_dofs, dtype=X.dtype, device=X.device)
        out[self._grid.reshape(-1)] = X.reshape(-1)
        return out

    # -- matvec -------------------------------------------------------------

    def apply_grid(self, X: torch.Tensor) -> torch.Tensor:
        """Stencil matvec in grid layout: X, result [n_i, n_j]."""
        return stencil_matvec(self._S, X)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Stencil matvec on flat [n_dofs] vectors, or on [n_dofs, ...]
        with trailing dims as independent right-hand sides (canonical
        layout only): one matvec over all of them."""
        if x.dim() == 1:
            return self.to_flat(self.apply_grid(self.to_grid(x)))
        if not self._reshape_ok:
            raise NotImplementedError("trailing right-hand sides need the "
                                      "canonical node layout")
        X = x.reshape(self.n_j, self.n_i, -1).permute(2, 1, 0)
        Y = self.apply_grid(X)                       # [b, n_i, n_j]
        return Y.permute(2, 1, 0).reshape(x.shape)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)

    def line_coeffs(self):
        """(sub, diag, sup) [n_i, n_j] along the j axis: the in-line
        tridiagonal part, sliced from the stencil."""
        return self._S[1, 0], self._S[1, 1], self._S[1, 2]
