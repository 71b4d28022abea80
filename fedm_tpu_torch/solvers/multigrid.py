"""Geometric multigrid V-cycle for the Poisson block on unstructured
(non-tensor-product) hierarchies (the JAX package's `solvers/multigrid.py`):
point-Chebyshev smoothing (fixed degree, so the V-cycle stays a fixed linear
operator, as BiCGStab requires), P1 gather/segment-sum transfers and a
precomputed dense inverse on the coarsest level.

The levels' own cell batches assemble by segment sum (`index_add_`), as the
JAX package's levels do: its ELL layout (K1) is switched on for the system's
batches only. A level on a canonical tensor-product grid would take the JAX
package's 9-point stencil and line-smoother branches instead; those come
with ROADMAP.md 9.4 and raise here.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..fem.assembly import CellBatch
from ..fem.interpolation import p1_transfer, prolong, restrict
from ..fem.space import FunctionSpace
from .chebyshev import chebyshev_solver, power_iteration_lmax
from .stencil import canonical_node_grid


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


class _Level:
    def __init__(self, space: FunctionSpace, batch: CellBatch,
                 mask: torch.Tensor):
        self.space = space
        self.batch = batch
        self.mask = mask
        self.n = space.n_dofs
        g2 = torch.sum(batch.grads * batch.grads, dim=-1)  # [c, 1, 3]
        contrib = batch.scale.sum(dim=1)[:, None] * g2[:, 0]
        diag = self.segment_sum(contrib)
        self.dtilde = torch.where(mask | (diag == 0), 1.0, diag)

    def segment_sum(self, contrib: torch.Tensor) -> torch.Tensor:
        """[n_cells, 3, ...] -> [n_dofs, ...], summed in element order."""
        trailing = tuple(contrib.shape[2:])
        out = torch.zeros((self.n,) + trailing, dtype=contrib.dtype,
                          device=contrib.device)
        return out.index_add_(0, self.batch.dofs.reshape(-1),
                              contrib.reshape((-1,) + trailing))

    def A(self, x: torch.Tensor) -> torch.Tensor:
        """The masked Laplacian (identity on Dirichlet rows), in the
        promoted type of the level's tables and `x`; trailing dims of `x`
        are independent right-hand sides."""
        b = self.batch.astype(torch.promote_types(self.batch.dtype,
                                                  x.dtype))
        m = _bcast(self.mask, x)
        x_in = torch.where(m, 0.0, x)
        Ax = self.segment_sum(b.stiffness(b.grad(b.gather(x_in))))
        return torch.where(m, x, Ax)

    def At(self, x: torch.Tensor) -> torch.Tensor:
        return self.A(x) / self.dtilde


class GeometricMultigrid:
    """Built from a fine-to-coarse list of spaces and Dirichlet masks.
    `precond(r)` applies one V-cycle approximating A^-1 r for the masked
    fine-level Laplacian (Dirichlet rows act as identity)."""

    def __init__(self, spaces: List[FunctionSpace], masks: List[np.ndarray],
                 axisymmetric: bool = False, quad_degree: int = 2,
                 dtype=None, smooth_degree: int = 3,
                 smooth_ratio: float = 15.0, power_iters: int = 30, *,
                 device):
        if len(spaces) < 2:
            raise ValueError("need at least two levels")
        for k, space in enumerate(spaces[:-1]):
            if canonical_node_grid(space) is not None:
                raise NotImplementedError(
                    f"level {k} is a tensor-product grid: its stencil and "
                    "line-smoother branches come with ROADMAP.md 9.4")
        self.device = torch.device(device)
        self.levels: List[_Level] = []
        for space, mask in zip(spaces, masks):
            batch = CellBatch(space, quad_degree=quad_degree,
                              axisymmetric=axisymmetric, dtype=dtype,
                              device=self.device)
            self.levels.append(_Level(space, batch, torch.as_tensor(
                np.asarray(mask), device=self.device)))

        self.transfers = [p1_transfer(spaces[k + 1], spaces[k], dtype=dtype,
                                      device=self.device)
                          for k in range(len(spaces) - 1)]

        self.lmax = []
        self.smoothers = []
        for lev in self.levels[:-1]:
            lmax = power_iteration_lmax(lev.At, lev.n, iters=power_iters,
                                        device=self.device)
            cheb = chebyshev_solver(lev.At, lmax / smooth_ratio, 1.05 * lmax,
                                    smooth_degree)
            self.lmax.append(lmax)
            self.smoothers.append(
                lambda r, cheb=cheb, lev=lev: cheb(r / lev.dtilde))

        # dense inverse on the coarsest level (setup, host float64): A
        # applied to the identity's columns as one batch in the level's type
        coarse = self.levels[-1]
        eye = torch.eye(coarse.n, dtype=coarse.dtilde.dtype,
                        device=self.device)
        cols = coarse.A(eye).cpu().numpy().astype(np.float64)
        self._coarse_inv = torch.as_tensor(np.linalg.inv(cols),
                                           dtype=coarse.dtilde.dtype,
                                           device=self.device)

    def _vcycle(self, k: int, r: torch.Tensor) -> torch.Tensor:
        if k == len(self.levels) - 1:
            return self._coarse_inv @ r
        lev = self.levels[k]
        smooth = self.smoothers[k]
        z = smooth(r)
        res = r - lev.A(z)
        idx, w = self.transfers[k]
        r_c = restrict(idx, w, res, self.levels[k + 1].n)
        r_c = torch.where(self.levels[k + 1].mask, 0.0, r_c)
        e_c = self._vcycle(k + 1, r_c)
        z = z + torch.where(lev.mask, 0.0, prolong(idx, w, e_c))
        z = z + smooth(r - lev.A(z))
        return z

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r)
