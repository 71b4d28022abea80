"""Geometric multigrid V-cycle for the Poisson block (the JAX package's
`solvers/multigrid.py`): point-Chebyshev smoothing (fixed degree, so the
V-cycle stays a fixed linear operator, as BiCGStab requires) or z-line
relaxation, and a precomputed dense inverse on the coarsest level.

A level on a tensor-product grid (given in `line_grids` or detected)
applies its operator as the extracted 9-point stencil (`StencilOp`), and
two such canonical levels transfer by the separable `StructuredTransfer`;
other levels apply the assembled operator and transfer by P1
gather/segment sums. The levels' own cell batches assemble by segment sum
(`index_add_`), as the JAX package's levels do: its ELL layout (K1) is
switched on for the system's batches only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..fem.assembly import CellBatch
from ..fem.interpolation import (StructuredTransfer, p1_transfer, prolong,
                                 restrict)
from ..fem.space import FunctionSpace
from .chebyshev import chebyshev_solver, power_iteration_lmax
from .linesmoother import ZLineSmoother, tridiag_solve_pcr
from .stencil import StencilOp, canonical_node_grid


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


def _is_canonical(grid) -> bool:
    if grid is None:
        return False
    n_i, n_j = grid.shape
    I, J = np.meshgrid(np.arange(n_i), np.arange(n_j), indexing="ij")
    return np.array_equal(np.asarray(grid), J * n_i + I)


class GeometricMultigrid:
    """Built from a fine-to-coarse list of spaces and Dirichlet masks.
    `precond(r)` applies one V-cycle approximating A^-1 r for the masked
    fine-level Laplacian (Dirichlet rows act as identity).

    `line_grids` (optional): per-level [n_i, n_j] dof-id grids; they
    switch the smoother from point Chebyshev to z-line relaxation, the
    anisotropy-robust choice for dz << dr corridor meshes."""

    def __init__(self, spaces: List[FunctionSpace], masks: List[np.ndarray],
                 axisymmetric: bool = False, quad_degree: int = 2,
                 dtype=None, smooth_degree: int = 3,
                 smooth_ratio: float = 15.0, power_iters: int = 30,
                 line_grids: Optional[List[np.ndarray]] = None, *,
                 device):
        if len(spaces) < 2:
            raise ValueError("need at least two levels")
        self.device = torch.device(device)
        self.levels: List[_Level] = []
        for space, mask in zip(spaces, masks):
            batch = CellBatch(space, quad_degree=quad_degree,
                              axisymmetric=axisymmetric, dtype=dtype,
                              device=self.device)
            self.levels.append(_Level(space, batch, torch.as_tensor(
                np.asarray(mask), device=self.device)))

        # each level's matvec: the extracted stencil on a tensor-product
        # grid, the assembled operator elsewhere (the coarsest level needs
        # only its dense inverse)
        self._grids = []
        for k, lev in enumerate(self.levels):
            if line_grids is not None and k < len(line_grids):
                self._grids.append(np.asarray(line_grids[k]))
            else:
                self._grids.append(canonical_node_grid(lev.space))
        self.ops = [lev.A for lev in self.levels]
        for k, lev in enumerate(self.levels[:-1]):
            if self._grids[k] is not None:
                try:
                    self.ops[k] = StencilOp(lev.A, self._grids[k], lev.n,
                                            dtype=dtype, device=self.device)
                except ValueError:
                    self._grids[k] = None

        # transfers fine k -> coarse k+1: separable on nested canonical
        # grids, P1 gather/segment sums otherwise
        self.transfers = []
        for k in range(len(spaces) - 1):
            st = None
            if (isinstance(self.ops[k], StencilOp) and self.ops[k]._reshape_ok
                    and _is_canonical(self._grids[k + 1])):
                cf, cc = spaces[k].dof_coords, spaces[k + 1].dof_coords
                try:
                    st = StructuredTransfer(
                        np.unique(cc[:, 0]), np.unique(cc[:, 1]),
                        np.unique(cf[:, 0]), np.unique(cf[:, 1]),
                        dtype=dtype, device=self.device)
                except ValueError:
                    st = None
            self.transfers.append(
                st if st is not None else
                p1_transfer(spaces[k + 1], spaces[k], dtype=dtype,
                            device=self.device))

        self.lmax = []
        self.smoothers = []
        for k, lev in enumerate(self.levels[:-1]):
            lined = (line_grids is not None and k < len(line_grids)
                     and line_grids[k] is not None)
            if lined and isinstance(self.ops[k], StencilOp):
                self.smoothers.append(self._line_smoother(self.ops[k]))
            elif lined:
                # no stencil for this level: the probing line smoother
                sm = ZLineSmoother(lev.A, line_grids[k], lev.n, n_iter=1,
                                   dtype=lev.dtilde.dtype, device=self.device)
                self.smoothers.append(sm.solve)
            else:
                A = self.ops[k]

                def At(x, A=A, lev=lev):
                    return A(x) / lev.dtilde

                lmax = power_iteration_lmax(At, lev.n, iters=power_iters,
                                            device=self.device)
                cheb = chebyshev_solver(At, lmax / smooth_ratio, 1.05 * lmax,
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

    @staticmethod
    def _line_smoother(st: StencilOp):
        """One PCR z-line solve with the stencil's in-line couplings."""
        a, b, c = st.line_coeffs()

        def smooth(r):
            X = tridiag_solve_pcr(a, b, c, st.to_grid(r).to(b.dtype))
            return st.to_flat(X).to(r.dtype)

        return smooth

    def _vcycle(self, k: int, r: torch.Tensor) -> torch.Tensor:
        if k == len(self.levels) - 1:
            # in the promoted type, as the JAX package's mixed matmul
            dt = torch.promote_types(self._coarse_inv.dtype, r.dtype)
            return self._coarse_inv.to(dt) @ r.to(dt)
        lev = self.levels[k]
        A = self.ops[k]
        smooth = self.smoothers[k]
        z = smooth(r)
        res = r - A(z)
        tr = self.transfers[k]
        structured = isinstance(tr, StructuredTransfer)
        r_c = (tr.restrict(res) if structured
               else restrict(tr[0], tr[1], res, self.levels[k + 1].n))
        r_c = torch.where(self.levels[k + 1].mask, 0.0, r_c)
        e_c = self._vcycle(k + 1, r_c)
        e_f = tr.prolong(e_c) if structured else prolong(tr[0], tr[1], e_c)
        z = z + torch.where(lev.mask, 0.0, e_f)
        z = z + smooth(r - A(z))
        return z

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r)
