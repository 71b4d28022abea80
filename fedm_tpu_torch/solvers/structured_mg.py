"""Structured-grid Poisson multigrid: the Poisson-block preconditioner for
tensor-product corridor meshes.

One V-cycle with z-line (PCR tridiagonal) smoothing, separable 2:1
transfers with graded weights, and a dense coarse inverse. The per-level
9-point stencils — the exact assembled P1 stiffness of the masked Laplacian
(Dirichlet rows identity, couplings into Dirichlet nodes zeroed) — the
transfer weights and the coarse inverse are assembled on the host in numpy,
as the JAX package does, and stored on the device in the compute dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import pi
from ..fem.interpolation import prolong_axis, restrict_axis
from .linesmoother import tridiag_solve_pcr
from .stencil import stencil_matvec


def p1_stiffness_stencil(xs: np.ndarray, zs: np.ndarray) -> np.ndarray:
    """Assembled 9-point stiffness stencil S[di+1, dj+1, n_i, n_j] of the
    axisymmetric (2*pi*r-weighted) P1 Laplacian on the canonical
    'right'-split mesh with coordinate lines (xs, zs); S[di+1, dj+1, i, j]
    multiplies x[i+di, j+dj]."""
    n_i, n_j = len(xs), len(zs)
    nx, nz = n_i - 1, n_j - 1
    hx = (xs[1:] - xs[:-1])[:, None] * np.ones((1, nz))
    hz = np.ones((nx, 1)) * (zs[1:] - zs[:-1])[None, :]
    area = 0.5 * hx * hz

    def tri_stencil(verts, grads):
        # exact for linear r: integral of 2*pi*r over the triangle
        r_cent = np.mean([xs[:-1][:, None] * np.ones((1, nz)) + dv[0] * hx
                          for dv in verts], axis=0)
        w = 2.0 * pi * r_cent * area
        return [(verts[a], verts[b],
                 w * (grads[a][0] * grads[b][0] + grads[a][1] * grads[b][1]))
                for a in range(3) for b in range(3)]

    zero = np.zeros_like(hx)
    # lower triangle (ll, lr, ur) and upper triangle (ll, ur, ul)
    lower = tri_stencil([(0, 0), (1, 0), (1, 1)],
                        [np.stack([-1.0 / hx, zero]),
                         np.stack([1.0 / hx, -1.0 / hz]),
                         np.stack([zero, 1.0 / hz])])
    upper = tri_stencil([(0, 0), (1, 1), (0, 1)],
                        [np.stack([zero, -1.0 / hz]),
                         np.stack([1.0 / hx, zero]),
                         np.stack([-1.0 / hx, 1.0 / hz])])
    S = np.zeros((3, 3, n_i, n_j))
    IX, IZ = np.meshgrid(np.arange(nx), np.arange(nz), indexing="ij")
    for va, vb, k in lower + upper:
        di, dj = vb[0] - va[0], vb[1] - va[1]
        np.add.at(S[di + 1, dj + 1], (IX + va[0], IZ + va[1]), k)
    return S


def apply_mask_to_stencil(S: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Masked rows become identity rows; couplings into masked nodes are
    zeroed."""
    S = S.copy()
    n_i, n_j = mask.shape
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            nb = np.zeros((n_i, n_j), dtype=bool)
            nb[max(-di, 0):n_i - max(di, 0),
               max(-dj, 0):n_j - max(dj, 0)] = mask[
                max(di, 0):n_i + min(di, 0), max(dj, 0):n_j + min(dj, 0)]
            S[di + 1, dj + 1][nb] = 0.0
            S[di + 1, dj + 1][mask] = 0.0
    S[1, 1][mask] = 1.0
    return S


class StructuredPoissonMG:
    """V-cycle preconditioner for the masked axisymmetric P1 Laplacian on
    nested canonical tensor-product grids.

    xs, zs : fine-level coordinate lines (cell counts divisible by
        2**(levels-1) for exact 2:1 slicing).
    mask_grid : [n_i, n_j] bool — Dirichlet nodes in grid-index space.
    """

    MIN_CELLS = 4  # coarsest level keeps at least this many cells per axis

    def __init__(self, xs, zs, mask_grid: np.ndarray, levels: int,
                 dtype=None, *, device):
        self.dtype = torch.float64 if dtype is None else dtype
        self.device = torch.device(device)
        xs, zs = np.asarray(xs, np.float64), np.asarray(zs, np.float64)
        masks = [np.asarray(mask_grid, bool)]
        self._shapes = [(len(xs), len(zs))]
        for _ in range(1, levels):
            nx, nz = self._shapes[-1][0] - 1, self._shapes[-1][1] - 1
            if (nx % 2 or nz % 2 or nx // 2 < self.MIN_CELLS
                    or nz // 2 < self.MIN_CELLS):
                break
            masks.append(masks[-1][::2, ::2])
            self._shapes.append((nx // 2 + 1, nz // 2 + 1))
        self.n_levels = len(self._shapes)
        if self.n_levels < 2:
            raise ValueError("need at least two levels (check divisibility)")
        self.n_i, self.n_j = self._shapes[0]
        self.n_dofs = self.n_i * self.n_j
        self._masks_np = masks
        self._masks = [torch.as_tensor(m, device=self.device) for m in masks]
        self._build(xs, zs)

    def update_geometry(self, xs, zs) -> None:
        """Rebuild the stencil hierarchy, the transfer weights and the
        coarse inverse for new coordinate lines with the same counts (the
        moving window's nodes), in place: same shapes, same device."""
        xs, zs = np.asarray(xs, np.float64), np.asarray(zs, np.float64)
        if (len(xs), len(zs)) != self._shapes[0]:
            raise ValueError(f"coordinate line counts {(len(xs), len(zs))} "
                             f"differ from the hierarchy's "
                             f"{self._shapes[0]}")
        self._build(xs, zs)

    def _put(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                               device=self.device)

    def _build(self, xs, zs) -> None:
        self.S, self.wx, self.wz = [], [], []
        for k in range(self.n_levels):
            S = apply_mask_to_stencil(p1_stiffness_stencil(xs, zs),
                                      self._masks_np[k])
            self.S.append(self._put(S))
            if k < self.n_levels - 1:
                xc, zc = xs[::2], zs[::2]
                self.wx.append(self._put((xs[1::2] - xc[:-1])
                                         / (xc[1:] - xc[:-1])))
                self.wz.append(self._put((zs[1::2] - zc[:-1])
                                         / (zc[1:] - zc[:-1])))
                xs, zs = xc, zc
        # dense coarse inverse: float64 on the host from the stored stencil
        S_c = self.S[-1].cpu().numpy().astype(np.float64)
        n_i, n_j = self._shapes[-1]
        A = np.zeros((n_i * n_j, n_i * n_j))
        I, J = np.meshgrid(np.arange(n_i), np.arange(n_j), indexing="ij")
        rows = (J * n_i + I).ravel()
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                ok = ((I + di >= 0) & (I + di < n_i)
                      & (J + dj >= 0) & (J + dj < n_j)).ravel()
                cols = ((J + dj) * n_i + (I + di)).ravel()
                A[rows[ok], cols[ok]] += S_c[di + 1, dj + 1].ravel()[ok]
        self.cinv = self._put(np.linalg.inv(A))

    def _smooth(self, S: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
        """One z-line (tridiagonal) solve in grid layout [n_i, n_j]."""
        return tridiag_solve_pcr(S[1, 0], S[1, 1], S[1, 2], R)

    def _vcycle(self, k: int, R: torch.Tensor) -> torch.Tensor:
        if k == self.n_levels - 1:
            n_i, n_j = self._shapes[k]
            if R.dim() == 3:
                # each right-hand side by itself, as a single one is
                return torch.stack([self._vcycle(k, X) for X in R])
            return (self.cinv @ R.T.reshape(-1)).reshape(n_j, n_i).T
        S = self.S[k]
        Z = self._smooth(S, R)
        res = R - stencil_matvec(S, Z)
        Rc = restrict_axis(res.mT, self.wx[k]).mT
        Rc = restrict_axis(Rc, self.wz[k])
        Rc = torch.where(self._masks[k + 1], 0.0, Rc)
        Ec = self._vcycle(k + 1, Rc)
        E = prolong_axis(Ec.mT, self.wx[k]).mT
        E = prolong_axis(E, self.wz[k])
        Z = Z + torch.where(self._masks[k], 0.0, E)
        return Z + self._smooth(S, R - stencil_matvec(S, Z))

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle approximating A^-1 r; r flat [n_dofs] in the
        canonical `id = j*n_i + i` layout, or [n_dofs, B]: B independent
        right-hand sides (`BatchedSystem`), in grid layout [B, n_i, n_j]."""
        if r.dim() == 2:
            X = r.t().reshape(-1, self.n_j, self.n_i).mT
            Z = self._vcycle(0, X.to(self.dtype))
            return Z.mT.reshape(r.shape[1], -1).t().to(r.dtype)
        X = r.reshape(self.n_j, self.n_i).T
        Z = self._vcycle(0, X.to(self.dtype))
        return Z.T.reshape(-1).to(r.dtype)
