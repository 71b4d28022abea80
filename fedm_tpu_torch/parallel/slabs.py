"""z-slabs of a structured tensor-product system over the ranks of a group:
the port of the JAX package's GSPMD production path
(`CoupledSystem.use_gspmd`).

The JAX package shards every nodal array of a canonical corridor mesh over
contiguous dof blocks (dof id = iz * n_i + ix, so the blocks are z-slabs)
and lets XLA's partitioner place the neighbour exchanges. Here each rank
of a `parallel.ranks.Group` (one process per card) holds one slab of node
rows, and the exchanges are written out:

Partition
---------
The coarsest multigrid level's z-cell rows are split evenly over the R
ranks at J_0 = 0 < J_1 < ... < J_R (the first ranks take one more where
they do not divide). At level k of L (0 the finest) rank r owns the node
rows [2^(L-1-k) J_r, 2^(L-1-k) J_{r+1}), and the last rank also the final
row. Restriction and prolongation along z then need one halo row each, and
odd node counts (2^k + 1 lines) need no padding.

Operations
----------
- `halo`: a rank's rows with one neighbour row below and/or above, one
  batched point-to-point exchange (zeros, or nothing, at the ends of the
  grid).
- `gather`: every rank's rows, concatenated in rank order (one all-gather
  of the slabs padded to the largest).
- `cell_view` / `facet_view`: a rank's part of the assembly, owner
  computes: the cell rows [a, b-1) that touch an own node row, on the
  extended node rows [a, b) = own rows plus one halo row on each inner
  side. Each own node sums the same contributions in the same order as on
  one card, so the residual, J v and the node blocks need no halo
  reduction and are the one-card values bit for bit (where the cell
  kernel's einsums round a row alike at both cell counts).

`SlabPoissonMG` is the structured V-cycle on slabs: the stencil matvec and
the separable transfers with one halo row, the z-line (PCR) smoothing on
the whole grid after one all-gather of the level's right-hand side (a line
crosses every slab), the dense coarse solve on the gathered coarsest grid;
each rank keeps its own rows. Every operation moves values only, so one
V-cycle equals one card's bit for bit. `SlabGeometricMG` is the geometric
multigrid's V-cycle on the same pieces, its point Chebyshev smoother on
own rows with one halo row per matvec; `SlabChebyshev` the Chebyshev
Poisson-row solve on own rows through the slab stiffness product;
`SlabLineSolver` the z-line smoother's solve.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..fem.interpolation import prolong_axis, restrict_axis
from ..solvers.chebyshev import ChebyshevSolve, chebyshev_solver
from ..solvers.linesmoother import tridiag_solve_pcr
from ..solvers.stencil import stencil_matvec


class SlabLayout:
    """The aligned partition of the node rows of a grid with `n_j` rows and
    `levels` 2:1 levels over `size` ranks (module docstring). Raises
    ValueError where the coarsest level has fewer cell rows than ranks."""

    def __init__(self, n_j: int, levels: int, size: int):
        cells = int(n_j) - 1
        f = 1 << (int(levels) - 1)
        if cells < 1 or cells % f:
            raise ValueError(f"{cells} z-cell rows do not coarsen "
                             f"{levels - 1} times by 2")
        n_c = cells // f
        if n_c < size:
            raise ValueError(f"{n_c} coarsest z-cell rows cannot be split "
                             f"over {size} ranks")
        q, rem = divmod(n_c, size)
        self.n_j, self.levels, self.size = int(n_j), int(levels), int(size)
        self.J = [r * q + min(r, rem) for r in range(size + 1)]

    def n_rows(self, level: int = 0) -> int:
        return ((self.n_j - 1) >> level) + 1

    def rows(self, rank: int, level: int = 0) -> Tuple[int, int]:
        """[lo, hi) of the node rows `rank` owns at `level`."""
        f = 1 << (self.levels - 1 - level)
        lo, hi = f * self.J[rank], f * self.J[rank + 1]
        return lo, hi + (1 if rank == self.size - 1 else 0)

    def counts(self, level: int = 0) -> List[int]:
        return [hi - lo for lo, hi in (self.rows(r, level)
                                       for r in range(self.size))]


class Slabs:
    """This rank's slab of a structured system with an [n_i, n_j] node grid
    (node id = j * n_i + i) over `group`: the layout, the halo exchange,
    the gathers and the views of the assembly (module docstring)."""

    def __init__(self, group, n_i: int, n_j: int, levels: int = 1):
        self.group = group
        self.layout = SlabLayout(n_j, levels, group.size)
        self.n_i, self.n_j = int(n_i), int(n_j)
        self.lo, self.hi = self.layout.rows(group.rank)
        # the extended node rows of the assembly: one halo row on each
        # inner side
        self.a = max(self.lo - 1, 0)
        self.b = min(self.hi + 1, self.n_j)
        self.n_ext = (self.b - self.a) * self.n_i
        # own rows inside the extended ones (flat dof range)
        self.own_ext = slice((self.lo - self.a) * self.n_i,
                             (self.hi - self.a) * self.n_i)

    # -- collectives ---------------------------------------------------------

    def halo(self, x: torch.Tensor, dim: int = 0, below: bool = True,
             above: bool = True, zeros: bool = False) -> torch.Tensor:
        """`x`, this rank's rows along `dim`, with the neighbour's row
        below (the last row of rank - 1) and/or above (the first row of
        rank + 1) attached, from one batched exchange. At the ends of the
        grid the missing row is a zero row with `zeros`, else left out. A
        collective: every rank asks for the same sides."""
        g = self.group
        r, R = g.rank, g.size
        m = x.shape[dim]
        sends, recvs = [], []
        shape = list(x.shape)
        shape[dim] = 1
        lo_buf = hi_buf = None
        if below:
            if r < R - 1:
                sends.append((r + 1, x.narrow(dim, m - 1, 1)))
            if r > 0:
                lo_buf = torch.empty(shape, dtype=x.dtype, device=x.device)
                recvs.append((r - 1, lo_buf))
        if above:
            if r > 0:
                sends.append((r - 1, x.narrow(dim, 0, 1)))
            if r < R - 1:
                hi_buf = torch.empty(shape, dtype=x.dtype, device=x.device)
                recvs.append((r + 1, hi_buf))
        g.exchange(sends, recvs)
        parts = []
        if below:
            if lo_buf is not None:
                parts.append(lo_buf)
            elif zeros:
                parts.append(torch.zeros(shape, dtype=x.dtype,
                                         device=x.device))
        parts.append(x)
        if above:
            if hi_buf is not None:
                parts.append(hi_buf)
            elif zeros:
                parts.append(torch.zeros(shape, dtype=x.dtype,
                                         device=x.device))
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    def gather(self, x: torch.Tensor, level: int = 0,
               dim: int = 0) -> torch.Tensor:
        """Every rank's rows of a level (`x`: this rank's, along `dim`),
        in rank order: one all-gather of the slabs padded to the largest."""
        g = self.group
        if g.size == 1:
            return x
        counts = self.layout.counts(level)
        m_max = max(counts)
        xt = x.movedim(dim, 0)
        if xt.shape[0] < m_max:
            pad = torch.zeros((m_max - xt.shape[0],) + tuple(xt.shape[1:]),
                              dtype=x.dtype, device=x.device)
            xt = torch.cat([xt, pad])
        allr = g.all_gather_rows(xt.contiguous())
        full = torch.cat([allr[q * m_max:q * m_max + c]
                          for q, c in enumerate(counts)])
        return full.movedim(0, dim)

    # -- the state layout: flat [n_j * n_i, ...] ------------------------------

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-grid nodal tensor [n_dofs, ...]."""
        return x[self.lo * self.n_i:self.hi * self.n_i]

    def fill(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [n_own, ...] -> the extended rows [n_ext, ...]
        the assembly gathers from (one exchange)."""
        rows = x.reshape((-1, self.n_i) + tuple(x.shape[1:]))
        return self.halo(rows).reshape((self.n_ext,) + tuple(x.shape[1:]))

    def gather_state(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows [n_own, ...] -> the whole grid's [n_dofs, ...]
        on every rank."""
        rows = x.reshape((-1, self.n_i) + tuple(x.shape[1:]))
        full = self.gather(rows, 0, 0)
        return full.reshape((-1,) + tuple(x.shape[1:]))

    # -- the assembly's batches ---------------------------------------------

    def cell_view(self, batch):
        """The structured cell batch's cells in rows [a, b-1) on the
        extended node rows [a, b): a structured batch of its own, its
        per-cell tables taken from `batch` (rows in order, lower then upper
        triangles, as the structured layout holds them)."""
        nx, ny = batch._structured
        c0, c1 = self.a, self.b - 1
        idx = np.concatenate([np.arange(k * nx * ny + c0 * nx,
                                        k * nx * ny + c1 * nx)
                              for k in (0, 1)])
        it = torch.as_tensor(idx, device=batch.device)
        view = copy.copy(batch)
        view.__dict__.pop("_views", None)
        for f in batch._SHARD_FIELDS:
            if f != "dofs":
                setattr(view, f, getattr(batch, f).index_select(0, it))
        view.dofs_np = batch.dofs_np[idx] - self.a * self.n_i
        view.dofs = torch.as_tensor(view.dofs_np, device=batch.device)
        view.n_dofs = self.n_ext
        view._structured = (nx, c1 - c0)
        view.gather_idx = view.scatter_idx = view.scatter_rows = None
        view.cells = idx
        return view

    def facet_view(self, batch):
        """The facets of `batch` that touch an own node row (their cells'
        nodes lie in the extended rows), in order, on the extended rows,
        scattered through their own ELL tables (K1); None where the rank
        holds none (it then launches nothing for them)."""
        row = batch.dofs_np // self.n_i
        sel = np.flatnonzero(((row >= self.lo) & (row < self.hi)).any(1))
        if sel.size == 0:
            return None
        arrays = {f: (batch.dofs_np[sel] - self.a * self.n_i if f == "dofs"
                      else getattr(batch, f).cpu().numpy()[sel])
                  for f in batch._SHARD_FIELDS}
        view = batch.local_view(arrays, self.n_ext)
        view.cells = sel
        return view


def slab_batches(slabs: Slabs, batches) -> list:
    """[(view, kernel)] of a system's (batch, kernel) pairs, the cell batch
    first: its slab view, and the facet batches' views that hold a facet."""
    out = []
    for i, (b, k) in enumerate(batches):
        v = slabs.cell_view(b) if i == 0 else slabs.facet_view(b)
        if v is not None:
            out.append((v, k))
    return out


class _SlabVCycle:
    """What the z-slab V-cycles share, on this rank's rows of every level
    of a whole-grid hierarchy `mg` (its `wx`, `wz` and `cinv` read at each
    call) in grid layout [n_i, rows]: a level's own columns, the
    separable transfers with one halo row along z, the coarse-grid
    correction and the dense coarse solve on the gathered coarsest grid.
    A subclass sets `mg`, `slabs`, `shapes` (each level's (n_i, n_j)) and
    gives `_mask(k)` and `_vcycle`."""

    def _check_aligned(self, n_levels: int, shape0: tuple) -> None:
        if (n_levels != self.slabs.layout.levels
                or tuple(shape0) != (self.slabs.n_i, self.slabs.n_j)):
            raise ValueError("the slabs are not aligned to this hierarchy")

    def _cols(self, k: int, T: torch.Tensor) -> torch.Tensor:
        lo, hi = self.slabs.layout.rows(self.slabs.group.rank, k)
        return T[..., lo:hi]

    def _with_halo(self, k: int, Z: torch.Tensor) -> torch.Tensor:
        """Own columns of the whole-grid Z with one column on each side
        (zeros beyond the grid), for the stencil."""
        lo, hi = self.slabs.layout.rows(self.slabs.group.rank, k)
        return F.pad(Z, (1, 1))[..., lo:hi + 2]

    def _smooth_full(self, k: int, R: torch.Tensor) -> torch.Tensor:
        """One z-line solve on the whole grid of the gathered R, with the
        stencil's in-line couplings, in their type (R's on return)."""
        S = self.mg.S[k]
        Rf = self.slabs.gather(R, k, dim=-1)
        return tridiag_solve_pcr(S[1, 0], S[1, 1], S[1, 2],
                                 Rf.to(S.dtype)).to(R.dtype)

    def _restrict_z(self, k: int, r: torch.Tensor) -> torch.Tensor:
        """`restrict_axis` along z of this rank's fine rows (last axis) to
        its coarse rows, with the fine row below from the neighbour."""
        sl, rank = self.slabs, self.slabs.group.rank
        clo, chi = sl.layout.rows(rank, k + 1)
        n_c = sl.layout.n_rows(k + 1)
        w = self.mg.wz[k]
        rh = sl.halo(r, dim=-1, below=True, above=False, zeros=True)
        even = rh[..., 1::2]
        odd = rh[..., 2::2]                       # rows 2J+1, J >= clo
        term_a = (1.0 - w[clo:clo + odd.shape[-1]]) * odd
        if chi == n_c:                            # the final coarse row
            term_a = F.pad(term_a, (0, 1))
        below = rh[..., 0:1]                      # row 2 clo - 1
        prev = torch.cat([below, odd[..., :chi - clo - 1]], dim=-1)
        if clo == 0:
            term_b = F.pad(w[0:chi - 1] * prev[..., 1:], (1, 0))
        else:
            term_b = w[clo - 1:chi - 1] * prev
        return even + term_a + term_b

    def _prolong_z(self, k: int, U: torch.Tensor) -> torch.Tensor:
        """`prolong_axis` along z of this rank's coarse rows to its fine
        rows, with the coarse row above from the neighbour."""
        sl, rank = self.slabs, self.slabs.group.rank
        clo, chi = sl.layout.rows(rank, k + 1)
        w = self.mg.wz[k]
        Uh = sl.halo(U, dim=-1, below=False, above=True)
        if Uh.shape[-1] > U.shape[-1]:            # the row above came
            return prolong_axis(Uh, w[clo:chi])[..., :-1]
        return prolong_axis(Uh, w[clo:chi - 1])   # the last rank

    def _coarse_correction(self, k: int, res: torch.Tensor) -> torch.Tensor:
        """The level-k residual's correction from level k+1: restricted,
        masked, the V-cycle below, prolonged and masked."""
        wx = self.mg.wx[k]
        Rc = self._restrict_z(k, restrict_axis(res.T, wx).T)
        Rc = torch.where(self._mask(k + 1), 0.0, Rc)
        E = prolong_axis(self._vcycle(k + 1, Rc).T, wx).T
        return torch.where(self._mask(k), 0.0, self._prolong_z(k, E))

    def _coarse_solve(self, k: int, R: torch.Tensor) -> torch.Tensor:
        """The dense inverse on the gathered coarsest grid, in the
        promoted type of it and R; this rank's columns."""
        n_i, n_j = self.shapes[k]
        Rf = self.slabs.gather(R, k, dim=-1).T.reshape(-1)
        cinv = self.mg.cinv
        dt = torch.promote_types(cinv.dtype, R.dtype)
        Z = (cinv.to(dt) @ Rf.to(dt)).reshape(n_j, n_i).T
        return self._cols(k, Z)


class SlabPoissonMG(_SlabVCycle):
    """`StructuredPoissonMG`'s V-cycle on this rank's slab of every level
    (module docstring). Reads the whole-grid hierarchy `mg` (stencils,
    transfer weights, coarse inverse: built on every rank as on one card,
    and updated in place by the moving window) at each call."""

    def __init__(self, mg, slabs: Slabs):
        self.mg, self.slabs, self.shapes = mg, slabs, mg._shapes
        self._check_aligned(mg.n_levels, mg._shapes[0])
        self.dtype = mg.dtype

    def _mask(self, k: int) -> torch.Tensor:
        return self._cols(k, self.mg._masks[k])

    def _vcycle(self, k: int, R: torch.Tensor) -> torch.Tensor:
        if k == self.mg.n_levels - 1:
            return self._coarse_solve(k, R)
        S_own = self._cols(k, self.mg.S[k])
        Zf = self._smooth_full(k, R)
        res = R - stencil_matvec(S_own, self._with_halo(k, Zf), halo=True)
        Z = self._cols(k, Zf) + self._coarse_correction(k, res)
        Zh = self.slabs.halo(Z, dim=-1, zeros=True)
        R2 = R - stencil_matvec(S_own, Zh, halo=True)
        return Z + self._cols(k, self._smooth_full(k, R2))

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle approximating A^-1 r; r this rank's rows, flat
        [n_own] in the `id = j*n_i + i` layout."""
        X = r.reshape(-1, self.slabs.n_i).T
        Z = self._vcycle(0, X.to(self.dtype))
        return Z.T.reshape(-1).to(r.dtype)


class SlabGeometricMG(_SlabVCycle):
    """`GeometricMultigrid`'s V-cycle on this rank's slab of every level,
    the slabs aligned to the hierarchy as for `SlabPoissonMG`: the point
    Chebyshev smoother on own rows (the whole-grid hierarchy's degree,
    ratio and per-level `lmax`, every matvec the level's stencil with one
    halo row on each side), or on a z-line level the PCR solve of the
    gathered right-hand side; the separable transfers; the dense coarse
    solve. Every operation is the whole-grid one's on this rank's values,
    so one V-cycle equals one card's rows bit for bit. Raises ValueError
    for a hierarchy with a level that is not a stencil on the canonical
    node layout or a P1 transfer (a structured grid builds neither)."""

    def __init__(self, mg, slabs: Slabs):
        if any(w is None for w in mg.wx):
            raise ValueError("the hierarchy has a level without a stencil "
                             "on the canonical node layout or a P1 "
                             "transfer, which the slabs do not split")
        self.mg, self.slabs, self.shapes = mg, slabs, mg.shapes
        self._check_aligned(mg.n_levels, self.shapes[0])

        def grid(k, v):
            n_i, n_j = self.shapes[k]
            return self._cols(k, v.reshape(n_j, n_i).T)

        self._masks = [grid(k, m) for k, m in enumerate(mg.masks)]
        self._smoothers = []
        for k, lmax in enumerate(mg.level_lmax):
            if lmax is None:
                self._smoothers.append(
                    lambda R, k=k: self._cols(k, self._smooth_full(k, R)))
                continue
            dt = grid(k, mg.dtilde[k])

            def At(X, k=k, dt=dt):
                return self._matvec(k, X) / dt

            cheb = chebyshev_solver(At, lmax / mg.smooth_ratio, 1.05 * lmax,
                                    mg.smooth_degree)
            self._smoothers.append(lambda R, cheb=cheb, dt=dt: cheb(R / dt))

    def _mask(self, k: int) -> torch.Tensor:
        return self._masks[k]

    def _matvec(self, k: int, Z: torch.Tensor) -> torch.Tensor:
        """The level's stencil on this rank's rows of Z (one exchange)."""
        return stencil_matvec(self._cols(k, self.mg.S[k]),
                              self.slabs.halo(Z, dim=-1, zeros=True),
                              halo=True)

    def _smooth(self, k: int, R: torch.Tensor) -> torch.Tensor:
        return self._smoothers[k](R)

    def _vcycle(self, k: int, R: torch.Tensor) -> torch.Tensor:
        if k == self.mg.n_levels - 1:
            return self._coarse_solve(k, R)
        Z = self._smooth(k, R)
        Z = Z + self._coarse_correction(k, R - self._matvec(k, Z))
        return Z + self._smooth(k, R - self._matvec(k, Z))

    def precond(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle approximating A^-1 r; r this rank's rows, flat
        [n_own] in the `id = j*n_i + i` layout."""
        Z = self._vcycle(0, r.reshape(-1, self.slabs.n_i).T)
        return Z.T.reshape(-1)


class SlabChebyshev(ChebyshevSolve):
    """`ChebyshevSolve.solve` on this rank's rows: its own rows of the
    whole grid's `dtilde`, the slab operator `A` (`masked_stiffness_op` on
    z-slabs) and the whole grid's `lmax`, degree and ratio (the lmax was
    estimated on every rank as on one card, at setup), so each rank's
    answer is one card's rows wherever the slab stiffness is."""

    def __init__(self, cheb: ChebyshevSolve, slabs: Slabs, A):
        super().__init__(A, slabs.own(cheb.dtilde), cheb.lmax, cheb.degree,
                         cheb.ratio)
        self.slabs = slabs


class SlabLineSolver:
    """`ZLineSmoother.solve` on this rank's rows: each line solve gathers
    the right-hand side and runs the whole-grid smoother's own solve (its
    couplings probed on every rank as on one card), keeping the own rows;
    the Richardson residual uses the slab operator `A`."""

    def __init__(self, smoother, slabs: Slabs, A):
        self.sm, self.slabs, self.A = smoother, slabs, A

    def _line_solve(self, r: torch.Tensor) -> torch.Tensor:
        return self.slabs.own(self.sm._line_solve(
            self.slabs.gather_state(r)))

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        x = self._line_solve(r)
        for _ in range(self.sm.n_iter - 1):
            x = x + self._line_solve(r - self.A(x).to(r.dtype))
        return x


def grid_shape(batch) -> Optional[Tuple[int, int]]:
    """(n_i, n_j) of a structured cell batch's node grid, or None."""
    if batch._structured is None:
        return None
    nx, ny = batch._structured
    return nx + 1, ny + 1
