"""Geometric multigrid V-cycle for the Poisson block (the JAX package's
`solvers/multigrid.py`): point-Chebyshev smoothing (fixed degree, so the
V-cycle stays a fixed linear operator, as BiCGStab requires) or z-line
relaxation, and a precomputed dense inverse on the coarsest level.

A level on a tensor-product grid (given in `line_grids` or detected)
applies its operator as the extracted 9-point stencil (`StencilOp`), and
two such canonical levels transfer by the separable `StructuredTransfer`;
other levels apply the assembled operator and transfer by P1
gather/segment sums. The levels' segment sums (their assembly, and the P1
restriction) go through K1's dense form (`ell_scatter`) over ELL tables
built once per level: each row adds its terms in element order, so the
sums are the same from run to run on the card, where `index_add_` adds
with atomics in an order that varies. The JAX package's levels use
`segment_sum`.

Every operator of a level, the V-cycle included, takes trailing
dimensions as independent right-hand sides (a batched sweep's members).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..fem.assembly import CellBatch, build_ell_index
from ..fem.interpolation import (StructuredTransfer, p1_transfer, prolong,
                                 restrict, restrict_table)
from ..fem.space import FunctionSpace
from ..ops.ell_scatter import ell_scatter
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
        # the segment sum's ELL table [n, max_val] over the flat
        # [n_cells * 3] contributions
        self._ell = torch.as_tensor(build_ell_index(batch.dofs_np, self.n),
                                    device=mask.device)
        g2 = torch.sum(batch.grads * batch.grads, dim=-1)  # [c, 1, 3]
        contrib = batch.scale.sum(dim=1)[:, None] * g2[:, 0]
        diag = self.segment_sum(contrib)
        self.dtilde = torch.where(mask | (diag == 0), 1.0, diag)

    def segment_sum(self, contrib: torch.Tensor) -> torch.Tensor:
        """[n_cells, 3, ...] -> [n_dofs, ...], summed in element order
        (K1's dense form; trailing dims are its C)."""
        trailing = tuple(contrib.shape[2:])
        return ell_scatter(contrib.reshape((-1,) + trailing).contiguous(),
                           self._ell)

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
        return self.A(x) / _bcast(self.dtilde, x)


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
            if st is None:
                idx, w = p1_transfer(spaces[k + 1], spaces[k], dtype=dtype,
                                     device=self.device)
                st = (idx, w, restrict_table(idx, spaces[k + 1].n_dofs))
            self.transfers.append(st)

        # the smoothers; the point-Chebyshev levels' parameters are kept
        # (`level_lmax`: None on a line-smoothed level) for the V-cycle's
        # z-slab form
        self.smooth_degree, self.smooth_ratio = smooth_degree, smooth_ratio
        self.level_lmax: List[Optional[float]] = []
        self.smoothers = []
        for k, lev in enumerate(self.levels[:-1]):
            lined = (line_grids is not None and k < len(line_grids)
                     and line_grids[k] is not None)
            self.level_lmax.append(None)
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
                    return A(x) / _bcast(lev.dtilde, x)

                lmax = power_iteration_lmax(At, lev.n, iters=power_iters,
                                            device=self.device)
                cheb = chebyshev_solver(At, lmax / smooth_ratio, 1.05 * lmax,
                                        smooth_degree)
                self.level_lmax[k] = lmax
                self.smoothers.append(
                    lambda r, cheb=cheb, lev=lev: cheb(
                        r / _bcast(lev.dtilde, r)))

        # dense inverse on the coarsest level (setup, host float64): A
        # applied to the identity's columns as one batch in the level's type
        coarse = self.levels[-1]
        eye = torch.eye(coarse.n, dtype=coarse.dtilde.dtype,
                        device=self.device)
        cols = coarse.A(eye).cpu().numpy().astype(np.float64)
        self._coarse_inv = torch.as_tensor(np.linalg.inv(cols),
                                           dtype=coarse.dtilde.dtype,
                                           device=self.device)

    # -- what a V-cycle on z-slabs reads (`parallel.slabs.SlabGeometricMG`)

    @property
    def lmax(self) -> List[float]:
        """The point-smoothed levels' lmax, in level order."""
        return [x for x in self.level_lmax if x is not None]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def shapes(self) -> List[Optional[tuple]]:
        """Each level's (n_i, n_j) node grid, None where it has none."""
        return [None if g is None else tuple(g.shape) for g in self._grids]

    @property
    def S(self) -> List[Optional[torch.Tensor]]:
        """Each level's 9-point stencil [3, 3, n_i, n_j] (`StencilOp`),
        None where the level applies the assembled operator."""
        return [op._S if isinstance(op, StencilOp) else None
                for op in self.ops]

    @property
    def wx(self) -> List[Optional[torch.Tensor]]:
        """The separable transfers' weights along r (None for P1)."""
        return [tr._wx if isinstance(tr, StructuredTransfer) else None
                for tr in self.transfers]

    @property
    def wz(self) -> List[Optional[torch.Tensor]]:
        """The separable transfers' weights along z (None for P1)."""
        return [tr._wz if isinstance(tr, StructuredTransfer) else None
                for tr in self.transfers]

    @property
    def masks(self) -> List[torch.Tensor]:
        """Each level's Dirichlet mask [n]."""
        return [lev.mask for lev in self.levels]

    @property
    def dtilde(self) -> List[torch.Tensor]:
        """Each level's Jacobi diagonal [n]."""
        return [lev.dtilde for lev in self.levels]

    @property
    def cinv(self) -> torch.Tensor:
        """The coarsest level's dense inverse."""
        return self._coarse_inv

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
               else restrict(tr[0], tr[1], res, self.levels[k + 1].n, tr[2]))
        r_c = torch.where(_bcast(self.levels[k + 1].mask, r_c), 0.0, r_c)
        e_c = self._vcycle(k + 1, r_c)
        e_f = tr.prolong(e_c) if structured else prolong(tr[0], tr[1], e_c)
        z = z + torch.where(_bcast(lev.mask, e_f), 0.0, e_f)
        z = z + smooth(r - A(z))
        return z

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r)

