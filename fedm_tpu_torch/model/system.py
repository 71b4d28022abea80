"""Coupled transient system: residual, Jacobian action and preconditioner
from element kernels.

The state is a dense float64 `u[n_dofs, n_eq]`. A model contributes

  cell_kernel(batch, delta_e, ctx)   -> [n_cells, n_local, n_eq]
  facet kernels (per marked boundary) -> [n_f, n_local, n_eq]

written with `model.forms`. Increment formulation: the Newton unknown is
delta = u - u_old, and the history difference d_hist = u_old - u_old1 is
formed in the float64 state before the cast to the compute dtype, so a
float32 compute path keeps every digit of the O(1e-4) increments of O(40)
log-densities. Kernels rebuild the absolute state as ctx['u_old'] + delta_e.

Assembly is scatter . kernel . gather, each batch's scatter adding into one
fresh zero tensor (`scatter_add`, in place on the ELL layout). Gather and
scatter are linear, so the Jacobian action is J v = scatter(J_e gather(v)),
with J_e gather(v) the kernel's tangent along gather(v): forward-mode AD
runs only through the plain-torch element kernels, never through the
scatter (whose ELL branch is an opaque CUDA kernel). The node-block Jacobi
preconditioner pushes the n_local*n_eq local tangent basis vectors through
the kernels the same way and keeps the same-node blocks; the same tangents
give the transport z-line couplings (`enable_transport_zline`) and, with
absolute values, the row norms of the row-equilibrated system
(`row_scaled`).

In float64 the basis vectors go through the kernels in one pass per Newton
iterate (`torch.func.vmap` over `torch.func.jvp`), and every J v applies
the element Jacobians J_e [n_elems, n_local*n_eq, n_local*n_eq] they
form: one batched product in place of a forward-mode pass. In float32
every J v is a forward-mode pass of its own and each basis vector one
more, as the JAX package computes them: there the element Jacobians'
other summation order moves the adaptive trajectories (dt) by ~1e-5, more
than they are held to the JAX package's.

`step` runs the host loop (`newton_solve`) when `NewtonConfig.host_loop`
is set and the system is not row-scaled, else the whole-solve loop
(`newton_krylov`), as the JAX package's `CoupledSystem.step` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..fem.assembly import CellBatch, FacetBatch
from ..fem.dirichlet import BCSet
from ..solvers.linear import _norm
from ..solvers.linesmoother import tridiag_solve_pcr
from ..solvers.newton import (NewtonConfig, newton_krylov,
                              newton_krylov_batched, newton_solve)
from ..solvers.precond import block_apply, invert_blocks


class StepParams(NamedTuple):
    """Scalar step parameters (float64 on the host)."""

    t: float
    dt: float
    dt_old: float


def _jvp(kernel: Callable, batch, ctx, u_e: torch.Tensor,
         t_e: torch.Tensor) -> torch.Tensor:
    """Tangent of `kernel(batch, u_e, ctx)` along `t_e` (forward-mode AD)."""
    with fwAD.dual_level():
        out = kernel(batch, fwAD.make_dual(u_e, t_e), ctx)
        return fwAD.unpack_dual(out).tangent


class StepOperators:
    """The system's operators at one attempted step, in one compute dtype:
    residual, Jacobian action and node blocks as functions of delta.

    `aux` holds per-step auxiliary fields (the glow's coefficients): every
    floating tensor is cast to the compute dtype, and each batch's kernel
    context gathers the nodal ones (a tensor whose leading dim is n_dofs)
    per element; other entries pass through (the JAX package's
    `_cast_inputs` and `_make_ctx`)."""

    def __init__(self, system: "CoupledSystem", u_old: torch.Tensor,
                 u_old1: torch.Tensor, params: StepParams, dtype,
                 aux: Optional[Dict] = None):
        self.n_dofs, self.n_eq = system.n_dofs, system.n_eq
        self.dtype = dtype
        self.mask = system.bcs.mask
        self._setup([(b.astype(dtype), k) for b, k in system._batches()],
                    system.bcs.values_at(params.t), u_old, u_old1, params,
                    aux)

    def _setup(self, batches, g, u_old, u_old1, params, aux) -> None:
        """The batches, the Dirichlet shift u_old - g and each batch's
        kernel context, the state's nodal tensors mapped by `_in` (the
        identity here; the domain decomposition's halo fill) before they
        are gathered."""
        dtype = self.dtype
        self.batches = batches
        # J v and the tangents from the element Jacobians (module docstring)
        self.element_jacobian = dtype == torch.float64
        d_hist = (u_old - u_old1).to(dtype)
        self.bc_shift = (u_old - g).to(dtype)
        p = StepParams(*(torch.tensor(x, dtype=dtype, device=u_old.device)
                         for x in params))

        def cast(v):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v.to(dtype)
            return v

        def nodal(v):
            return (isinstance(v, torch.Tensor) and v.dim() >= 1
                    and v.shape[0] == u_old.shape[0])

        aux = {k: cast(v) for k, v in (aux or {}).items()}
        aux_in = {k: self._in(v) if nodal(v) else v for k, v in aux.items()}
        u_old_in, d_hist_in = self._in(u_old.to(dtype)), self._in(d_hist)

        def ctx(b):
            c = {name: b.gather(v) if nodal(aux[name]) else v
                 for name, v in aux_in.items()}
            c.update(u_old=b.gather(u_old_in), d_hist=b.gather(d_hist_in),
                     params=self._params_for(b, p))
            return c

        self.ctxs = [ctx(b) for b, _ in self.batches]
        # (delta, its version, per-batch tangents) of the last delta
        self._tangents = None

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """A state-layout tensor as the batches gather it."""
        return x

    def _params_for(self, batch, p: StepParams) -> StepParams:
        """The step parameters as `batch`'s kernels read them (the same
        scalars for every element here)."""
        return p

    def _out(self, r: torch.Tensor) -> torch.Tensor:
        """The batches' summed scatter as a state-layout tensor."""
        return r

    def _cells(self, t: torch.Tensor) -> torch.Tensor:
        """A per-cell table of the system's cell batch [n_cells, ...] for
        the cells of this operator's cell batch."""
        return t

    def _zeros(self, *trailing):
        return torch.zeros((self.n_dofs,) + trailing, dtype=self.dtype,
                           device=self.mask.device)

    def residual(self, delta: torch.Tensor) -> torch.Tensor:
        """R(delta), Dirichlet rows delta + (u_old - g)."""
        delta = delta.to(self.dtype)
        d_in = self._in(delta)
        out = self._zeros(self.n_eq)
        for (batch, kernel), ctx in zip(self.batches, self.ctxs):
            out = batch.scatter_add(
                out, kernel(batch, batch.gather(d_in), ctx))
        return torch.where(self.mask, delta + self.bc_shift, self._out(out))

    def jacobian_action(self, delta: torch.Tensor) -> Callable:
        """v -> J(delta) v (Dirichlet rows identity). With
        `element_jacobian`, each product applies the element Jacobians
        [n_elems, n_local*n_eq, n_local*n_eq] of `_all_tangents` (one
        batched forward-mode pass per delta, shared with the node blocks);
        otherwise each product is a forward-mode pass of its own."""
        if self.element_jacobian:
            Js = [T.reshape(T.shape[0], -1).t().reshape(
                T.shape[1], T.shape[0], T.shape[0]).contiguous()
                for T in self._all_tangents(delta)]

            def apply_elem(v: torch.Tensor) -> torch.Tensor:
                v_in = self._in(v)
                out = self._zeros(self.n_eq)
                for (batch, _), J in zip(self.batches, Js):
                    v_e = batch.gather(v_in).reshape(J.shape[0], -1, 1)
                    out = batch.scatter_add(
                        out, torch.bmm(J, v_e).reshape(batch.dofs.shape
                                                       + (self.n_eq,)))
                return torch.where(self.mask, v, self._out(out))

            return apply_elem
        d_in = self._in(delta)
        lin = [(batch, ctx, batch.gather(d_in), kernel)
               for (batch, kernel), ctx in zip(self.batches, self.ctxs)]

        def apply(v: torch.Tensor) -> torch.Tensor:
            v_in = self._in(v)
            out = self._zeros(self.n_eq)
            for batch, ctx, u_e, kernel in lin:
                t = _jvp(kernel, batch, ctx, u_e, batch.gather(v_in))
                out = batch.scatter_add(out, t)
            return torch.where(self.mask, v, self._out(out))

        return apply

    def _all_tangents(self, delta: torch.Tensor) -> list:
        """Per batch, the kernel's tangents along every local basis vector
        e_(a, j) at `delta`, T [n_local*n_eq, n_elems, n_local, n_eq] with
        row a*n_eq + j: one forward-mode pass with the basis batched
        (`torch.func.vmap` over `torch.func.jvp`), cached for the last
        `delta` (Newton asks for J v and the node blocks at one iterate)."""
        key = (delta, delta._version)
        if self._tangents is None or (self._tangents[0] is not key[0]
                                      or self._tangents[1] != key[1]):
            from torch.func import jvp, vmap

            d_in = self._in(delta)
            Ts = []
            for (batch, kernel), ctx in zip(self.batches, self.ctxs):
                u_e = batch.gather(d_in)
                n_elems, nl = batch.dofs.shape
                k = nl * self.n_eq
                basis = torch.eye(k, dtype=u_e.dtype, device=u_e.device
                                  ).reshape(k, 1, nl, self.n_eq).expand(
                    k, n_elems, nl, self.n_eq)

                def push(t, batch=batch, kernel=kernel, ctx=ctx, u_e=u_e):
                    return jvp(lambda ue: kernel(batch, ue, ctx), (u_e,),
                               (t,))[1]

                Ts.append(vmap(push)(basis))
            self._tangents = key + (Ts,)
        return self._tangents[2]

    def _local_tangents(self, bi: int, delta: torch.Tensor, d_in):
        """(a, j, t) for every local tangent basis vector e_(a, j) of batch
        `bi`: t is the kernel's tangent [n_elems, n_local, n_eq] along it
        at `delta` (from `_all_tangents` with `element_jacobian`, else
        one forward-mode pass each, at `d_in`)."""
        if self.element_jacobian:
            T = self._all_tangents(delta)[bi]
            for a in range(T.shape[2]):
                for j in range(self.n_eq):
                    yield a, j, T[a * self.n_eq + j]
            return
        (batch, kernel), ctx = self.batches[bi], self.ctxs[bi]
        u_e = batch.gather(d_in)
        for a in range(u_e.shape[1]):
            for j in range(self.n_eq):
                tan = torch.zeros_like(u_e)
                tan[:, a, j] = 1.0
                yield a, j, _jvp(kernel, batch, ctx, u_e, tan)

    def _tangent_input(self, delta: torch.Tensor):
        """`_in(delta)` for `_local_tangents`, made once for all batches (on
        z-slabs a collective, which every rank makes however many batches
        it holds); None with `element_jacobian` (`_all_tangents` fills)."""
        return None if self.element_jacobian else self._in(delta)

    def jacobian_blocks(self, delta: torch.Tensor, zline=None):
        """Exact per-dof diagonal blocks B[n, i, j] = dR_i/d delta_j at dof n
        [n_dofs, n_eq, n_eq]; Dirichlet rows are identity rows.

        `zline` = (eqs, m_sub, m_sup): from the same tangents, also the
        cell batch's z-neighbour couplings of each equation in `eqs`,
        J[row, row -/+ n_i][e, e]: sub and sup [n_dofs, len(eqs)], zero on
        Dirichlet rows. `m_sub`/`m_sup` [n_cells, b_out, a_in] mark the
        local pairs whose dofs differ by +/- n_i. Returns blocks, or
        (blocks, (sub, sup)) with `zline`."""
        ne = self.n_eq
        blocks = self._zeros(ne, ne)
        zc = None
        d_in = self._tangent_input(delta)
        if zline is not None:
            zline = (zline[0], self._cells(zline[1]), self._cells(zline[2]))
        for bi, (batch, _) in enumerate(self.batches):
            n_elems, nl = batch.dofs.shape
            # diag[c, a, i, j] = d contrib(c, a, i) / d u_e(c, a, j)
            diag = torch.empty((n_elems, nl, ne, ne), dtype=self.dtype,
                               device=delta.device)
            cross = None
            if zline is not None and bi == 0:
                eqs, m_sub, m_sup = zline
                cross = torch.zeros((n_elems, nl, len(eqs), 2),
                                    dtype=self.dtype, device=delta.device)
            for a, j, t in self._local_tangents(bi, delta, d_in):
                diag[:, a, :, j] = t[:, a, :]
                if cross is not None and j in eqs:
                    k = eqs.index(j)
                    cross[:, :, k, 0] += m_sub[:, :, a] * t[:, :, j]
                    cross[:, :, k, 1] += m_sup[:, :, a] * t[:, :, j]
            blocks = batch.scatter_add(blocks, diag)
            if cross is not None:
                zc = self._out(batch.scatter_add(self._zeros(len(eqs), 2),
                                                 cross))
        blocks = self._out(blocks)
        eye = torch.eye(ne, dtype=self.dtype, device=blocks.device)
        blocks = torch.where(self.mask[:, :, None], eye, blocks)
        if zline is None:
            return blocks
        row_mask = self.mask[:, list(zline[0])]
        return blocks, (torch.where(row_mask, 0.0, zc[..., 0]),
                        torch.where(row_mask, 0.0, zc[..., 1]))

    def row_l1(self, delta: torch.Tensor) -> torch.Tensor:
        """Upper bound on the assembled Jacobian's l1 row norms [n_dofs,
        n_eq]: sum over elements and local columns of |d contrib / d
        delta|, neighbour couplings included."""
        norms = self._zeros(self.n_eq)
        d_in = self._tangent_input(delta)
        for bi, (batch, _) in enumerate(self.batches):
            contrib = None
            for _, _, t in self._local_tangents(bi, delta, d_in):
                contrib = t.abs() if contrib is None else contrib + t.abs()
            norms = batch.scatter_add(norms, contrib)
        return self._out(norms)


class SlabOperators(StepOperators):
    """`StepOperators` of a system on z-slabs (`CoupledSystem.use_gspmd`):
    delta, the state and the results are this rank's node rows; each
    operation fills the one-row halo of its input (`Slabs.fill`, one
    exchange), runs the batches' slab views over the extended rows and
    keeps the own rows. No halo reduction: every own node sums what it
    sums on one card, in the same order."""

    def __init__(self, system: "CoupledSystem", u_old: torch.Tensor,
                 u_old1: torch.Tensor, params: StepParams, dtype,
                 aux: Optional[Dict] = None):
        sl = self.slabs = system.slabs
        self.n_dofs, self.n_eq = sl.n_ext, system.n_eq
        self.dtype = dtype
        self.mask = sl.own(system.bcs.mask)
        self._setup([(b.astype(dtype), k) for b, k in system.slab_batches],
                    sl.own(system.bcs.values_at(params.t)), u_old, u_old1,
                    params, aux)

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        return self.slabs.fill(x)

    def _out(self, r: torch.Tensor) -> torch.Tensor:
        return r[self.slabs.own_ext]

    def _cells(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.batches[0][0].cells_t]


class ShardOperators(StepOperators):
    """`StepOperators` of the round-1 sharded system (`CoupledSystem.shard`):
    the state is whole on every rank, each rank's batches hold its block of
    the elements (scattered through their own ELL tables, K1), and each
    assembled result is the sum of the ranks' (one all-reduce)."""

    def __init__(self, system: "CoupledSystem", u_old: torch.Tensor,
                 u_old1: torch.Tensor, params: StepParams, dtype,
                 aux: Optional[Dict] = None):
        self.group = system._shard[0]
        self.n_dofs, self.n_eq = system.n_dofs, system.n_eq
        self.dtype = dtype
        self.mask = system.bcs.mask
        self._setup([(b.astype(dtype), k) for b, k in system._shard[1]],
                    system.bcs.values_at(params.t), u_old, u_old1, params,
                    aux)

    def _out(self, r: torch.Tensor) -> torch.Tensor:
        return self.group.all_reduce(r)


def _block_precond(ops: StepOperators, tzline, tz_solver: Callable, ell,
                   row_weights: Optional[torch.Tensor]) -> Callable:
    """`CoupledSystem.block_precond_builder` on `ops`' rows: `tzline` the
    system's transport z-lines (or None), `tz_solver(blocks, sub, sup)`
    their solve, `ell` (eq, solve of the row's [n_rows] right-hand side)
    or None."""
    tz = tzline if row_weights is None else None

    def build(delta):
        if tz is not None:
            eqs, _, m_sub, m_sup = tz
            blocks, (sub, sup) = ops.jacobian_blocks(
                delta, (eqs, m_sub, m_sup))
            tz_solve = tz_solver(blocks, sub, sup)
        else:
            blocks = ops.jacobian_blocks(delta)
            tz_solve = None
        if row_weights is not None:
            blocks = row_weights[:, :, None] * blocks
        inv = invert_blocks(blocks)

        def M(r):
            y = block_apply(inv, r)
            if tz_solve is not None:
                y[:, list(tz[0])] = tz_solve(r[:, list(tz[0])])
            if ell is not None:
                eq, solve = ell
                r_eq = r[:, eq]
                if row_weights is not None:
                    r_eq = r_eq / row_weights[:, eq]
                y[:, eq] = solve(r_eq)
            return y

        return M

    return build


class CoupledSystem:
    def __init__(self, cell_batch: CellBatch, n_eq: int, bcs: BCSet,
                 newton: NewtonConfig = NewtonConfig()):
        self.cell_batch = cell_batch
        self.n_eq = n_eq
        self.n_dofs = cell_batch.n_dofs
        self.bcs = bcs
        self.newton = newton
        self.cell_kernel: Optional[Callable] = None
        self.facet_kernels: List[Tuple[FacetBatch, Callable]] = []
        self._ell = None  # (eq, solve) of the elliptic preconditioner
        self._tzline = None  # (eqs, node grid [n_i, n_j], z-line masks)
        # absolute Newton target set by the driver (its floor_atol)
        self.dyn_atol = 0.0
        # row equilibration by the assembled l1 row norms; always solved
        # by `newton_krylov`, without the float64 defect
        self.row_scaled = False
        # with `row_scaled`: an absolute target of this times ||u_old||
        # (0 disables)
        self.row_scaled_atol_rel = 0.0
        # z-slabs over a group (`use_gspmd`): the layout, the batches' slab
        # views, and the group every reduction of a step runs over
        self.slabs = None
        self.slab_batches = None
        self.group = None
        # the round-1 sharding (`shard`): (group, the rank's batches)
        self._shard = None

    @property
    def dtype(self):
        return self.cell_batch.dtype

    def set_cell_kernel(self, fn: Callable) -> None:
        self.cell_kernel = fn

    def add_facet_kernel(self, batch: FacetBatch, fn: Callable) -> None:
        self.facet_kernels.append((batch, fn))

    def _batches(self):
        yield self.cell_batch, self.cell_kernel
        yield from self.facet_kernels

    def use_gather_scatter(self) -> None:
        """Structured slice/pad assembly where the cell batch is a canonical
        tensor-product grid, the ELL gather-sum everywhere else."""
        for batch, _ in self._batches():
            if not (isinstance(batch, CellBatch) and batch.try_structured()):
                batch.build_scatter_meta()

    def update_geometry(self, batches) -> None:
        """Install the coordinate-derived tables of `batches` (the cell
        batch, then the facet batches, in the order the system holds them)
        built on the same topology with moved nodes; see
        `_Batch.set_geometry`. A geometry-carrying preconditioner is
        updated by its owner."""
        held = list(self._batches())
        if len(batches) != len(held):
            raise ValueError(f"{len(batches)} batches for the system's "
                             f"{len(held)}")
        for (b, _), new in zip(held, batches):
            b.set_geometry(new)
        if self.slabs is not None:
            self._slice_batches()

    # -- multi-card: z-slabs (the production path) and the round-1 shard --

    def use_gspmd(self, group) -> None:
        """Put this structured system on z-slabs over `group`
        (`parallel.ranks.Group`, one rank per card): the counterpart of
        the JAX package's `use_gspmd` (`parallel.slabs`). Every state the
        system then takes and returns is this rank's node rows
        (`place_state`; `gather_state` gives the whole grid back), every
        reduction of a step runs over the group, and the Poisson row's
        preconditioner moves to the slabs, whichever the JAX package's
        `use_gspmd` takes: the structured V-cycle (`SlabPoissonMG`) or the
        geometric multigrid, point- or z-line-smoothed
        (`SlabGeometricMG`), the slabs aligned to the hierarchy's levels;
        the z-line smoother (`SlabLineSolver`); the Chebyshev solve
        (`SlabChebyshev`). Raises ValueError without structured assembly,
        as the JAX package does, for a hierarchy that is not a stencil on
        every level with separable transfers (a structured grid's always
        is), and for a preconditioner of none of these kinds (the slabs
        would not know its rows)."""
        from ..parallel.slabs import (SlabChebyshev, SlabGeometricMG,
                                      SlabLineSolver, SlabPoissonMG, Slabs,
                                      grid_shape)
        from ..solvers.chebyshev import ChebyshevSolve
        from ..solvers.linesmoother import ZLineSmoother
        from ..solvers.multigrid import GeometricMultigrid
        from ..solvers.structured_mg import StructuredPoissonMG

        shape = grid_shape(self.cell_batch)
        if shape is None:
            raise ValueError("use_gspmd needs structured assembly "
                             "(CellBatch.try_structured, through "
                             "use_gather_scatter)")
        if self._shard is not None:
            raise ValueError("the system is sharded (shard); z-slabs take "
                             "a system that is not")
        owner = (None if self._ell is None
                 else getattr(self._ell[1], "__self__", None))
        slab_form = {StructuredPoissonMG: SlabPoissonMG,
                     GeometricMultigrid: SlabGeometricMG,
                     ChebyshevSolve: SlabChebyshev,
                     ZLineSmoother: SlabLineSolver}.get(type(owner))
        if self._ell is not None and slab_form is None:
            raise ValueError(f"the Poisson-row preconditioner "
                             f"{self._ell[1]!r} is none of the "
                             f"multigrids, the z-line smoother or the "
                             f"Chebyshev solve, whose rows the slabs know")
        multigrid = isinstance(owner, (StructuredPoissonMG,
                                       GeometricMultigrid))
        slabs = Slabs(group, *shape, owner.n_levels if multigrid else 1)
        if multigrid:
            solve = slab_form(owner, slabs).precond  # may refuse: before
        self.slabs = slabs                          # the system changes
        self.group = group
        self._slice_batches()
        if self._ell is None:
            return
        eq = self._ell[0]
        if not multigrid:
            solve = slab_form(owner, slabs,
                              self.masked_stiffness_op(eq)).solve
        self._ell = (eq, solve)

    def _slice_batches(self) -> None:
        from ..parallel.slabs import slab_batches

        self.slab_batches = slab_batches(self.slabs, list(self._batches()))
        v = self.slab_batches[0][0]
        v.cells_t = torch.as_tensor(v.cells, device=v.device)

    def place_state(self, x: torch.Tensor) -> torch.Tensor:
        """A whole-grid nodal tensor [n_dofs, ...] as the system holds it:
        this rank's node rows on z-slabs, else `x` itself."""
        return x if self.slabs is None else self.slabs.own(x)

    def gather_state(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of `place_state` (on z-slabs a collective: every
        rank gets the whole grid)."""
        return x if self.slabs is None else self.slabs.gather_state(x)

    def shard(self, group) -> None:
        """The round-1 route (the JAX package's `shard`): every batch's
        elements split over the ranks of `group` in blocks, padded to a
        multiple of the rank count with elements that have no scatter slot
        (as `pad_to` pads), each block scattered through its own ELL table
        (K1). The state stays whole on every rank; assembly, J v and the
        node blocks are a local sum plus one all-reduce, and the solvers
        run on the whole (identical) vectors."""
        if self.slabs is not None:
            raise ValueError("the system is on z-slabs (use_gspmd)")
        R, rank = group.size, group.rank
        views = []
        for batch, kernel in self._batches():
            n = batch.dofs_np.shape[0]
            per = -(-n // R)
            idx = np.arange(rank * per, (rank + 1) * per)
            dead = idx >= n
            idx = np.minimum(idx, n - 1)
            arrays = {f: (batch.dofs_np[idx] if f == "dofs"
                          else getattr(batch, f).cpu().numpy()[idx])
                      for f in batch._SHARD_FIELDS}
            views.append((batch.local_view(arrays, batch.n_dofs, dead),
                          kernel))
        self._shard = (group, views)

    def enable_elliptic_precond(self, eq: int, degree: int = 12,
                                ratio: float = 30.0, power_iters: int = 40,
                                mg=None, solver=None) -> None:
        """Replace the node-block answer on row `eq` by an approximate
        solve of that component's masked Laplacian: one V-cycle of `mg`
        (an object with `precond(r)`), any linear operator `solver`
        (r -> ~A^-1 r, e.g. `ZLineSmoother.solve`), or else a Chebyshev
        polynomial of the given degree in the Jacobi-scaled operator. The
        multigrid and the Chebyshev solve take r [n_dofs] or [n_dofs, B],
        B independent right-hand sides (`BatchedSystem`)."""
        from ..solvers.chebyshev import ChebyshevSolve
        from ..solvers.elliptic import stiffness_diagonal

        if solver is not None:
            self._ell = (eq, solver)
            return
        if mg is not None:
            self._ell = (eq, mg.precond)
            return
        mask = self.bcs.mask[:, eq]
        diag = stiffness_diagonal(self.cell_batch)
        dtilde = torch.where(mask | (diag == 0), 1.0, diag)
        cheb = ChebyshevSolve.build(self.masked_stiffness_op(eq), dtilde,
                                    degree, ratio, power_iters)
        self._ell = (eq, cheb.solve)

    def masked_stiffness_op(self, eq: int) -> Callable:
        """The masked Laplacian of component `eq` on [n_dofs] vectors
        (identity on Dirichlet rows), in the cell batch's type: the
        operator the elliptic preconditioners approximate."""
        mask = self.bcs.mask[:, eq]
        b = self.cell_batch
        sl = self.slabs
        if sl is not None:
            mask = sl.own(mask)

        def A(x):
            m = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
            x_in = torch.where(m, 0.0, x).to(b.dtype)
            if sl is None:
                Ax = b.scatter(b.stiffness(b.grad(b.gather(x_in))))
            else:
                v = self.slab_batches[0][0]
                Ax = v.scatter(v.stiffness(v.grad(v.gather(
                    sl.fill(x_in)))))[sl.own_ext]
            return torch.where(m, x, Ax)

        return A

    def enable_transport_zline(self, eqs, node_grid) -> None:
        """Per-z-line tridiagonal preconditioning of the transport rows
        `eqs` on a canonical tensor-product grid: each application solves,
        per line of `node_grid` [n_i, n_j] (lines along j, z-neighbour
        stride n_i), the tridiagonal of the exact z-couplings the block
        build extracts, and replaces the node-block answer on those rows
        (not under `row_scaled`: the tridiagonal is assembled unscaled)."""
        grid = np.asarray(node_grid)
        n_i = int(grid.shape[0])
        # [c, b_out, a_in]: local pairs whose dofs differ by -/+ n_i
        dofs = self.cell_batch.dofs_np
        d = dofs[:, :, None] - dofs[:, None, :]
        dev, dt = self.bcs.mask.device, self.dtype
        self._tzline = (tuple(int(e) for e in eqs),
                        torch.as_tensor(grid, device=dev),
                        torch.as_tensor(d == n_i, dtype=dt, device=dev),
                        torch.as_tensor(d == -n_i, dtype=dt, device=dev))

    def _tzline_solver(self, blocks, sub, sup, grid=None) -> Callable:
        """r [n_dofs, n_sel] -> the per-z-line tridiagonal solves with the
        exact (sub, diag, sup) couplings, diag from the node blocks.
        `grid`: the lines' dof ids in place of the node grid (a
        `BatchedSystem`'s members' grids stacked, [B*n_i, n_j])."""
        eqs = self._tzline[0]
        if grid is None:
            grid = self._tzline[1]
        flat = grid.reshape(-1)
        # on z-slabs a line crosses every slab: the couplings are gathered
        # once, each right-hand side per application, and every rank solves
        # the whole grid and keeps its rows (on one card both are the
        # identity)
        sl = self.slabs
        whole = (lambda x: x) if sl is None else sl.gather_state
        own = (lambda x: x) if sl is None else sl.own
        coef = [tuple(whole(c)[grid] for c in
                      (sub[:, k], blocks[:, e, e], sup[:, k]))
                for k, e in enumerate(eqs)]

        def solve(r):
            out = torch.empty_like(r)
            for k, (a, b, c) in enumerate(coef):
                x = tridiag_solve_pcr(a, b, c, whole(r[:, k])[grid])
                y = torch.empty(flat.shape[0], dtype=x.dtype, device=x.device)
                y[flat] = x.reshape(-1)
                out[:, k] = own(y)
            return out

        return solve

    def _hi_enabled(self) -> bool:
        return self.newton.hi_residual and self.dtype != torch.float64

    def operators(self, u_old, u_old1, params: StepParams, dtype=None,
                  aux: Optional[Dict] = None) -> StepOperators:
        kind = (SlabOperators if self.slabs is not None else
                ShardOperators if self._shard is not None else StepOperators)
        return kind(self, u_old, u_old1, params,
                    self.dtype if dtype is None else dtype, aux)

    def residual(self, u, u_old, u_old1, params: StepParams, dtype=None,
                 aux: Optional[Dict] = None):
        """Residual at the absolute state `u` (diagnostics, tests)."""
        ops = self.operators(u_old, u_old1, params, dtype, aux)
        return ops.residual((u - u_old).to(ops.dtype))

    def block_precond_builder(self, ops: StepOperators,
                              row_weights: Optional[torch.Tensor] = None
                              ) -> Callable:
        """delta -> M, with M^-1 the inverted node blocks, on the transport
        z-line rows their tridiagonal solves, and on the elliptic row its
        solve. With `row_weights` [n_dofs, n_eq] (a row-equilibrated
        residual) the blocks are the scaled w*B, the elliptic solve sees
        the unscaled r/w, and no z-line solve runs."""
        return _block_precond(ops, self._tzline, self._tzline_solver,
                              self._ell, row_weights)

    def row_weights(self, ops: StepOperators,
                    delta: torch.Tensor) -> torch.Tensor:
        """1 / (assembled l1 row norm) at `delta`, 1 where that norm is 0
        or not finite and on Dirichlet rows."""
        rownorm = ops.row_l1(delta)
        w = torch.where((rownorm > 0) & torch.isfinite(rownorm),
                        1.0 / rownorm, 1.0)
        return torch.where(ops.mask, 1.0, w).to(rownorm.dtype)

    def guarded_block_count(self, u_old, u_old1, params: StepParams,
                            aux: Optional[Dict] = None) -> int:
        """Diagnostic: how many node blocks at the state u_old (delta = 0)
        need the Jacobi fallback of `invert_blocks`. A handful is the
        expected underflow case; a systematic count is an assembly defect
        the fallback would otherwise hide."""
        ops = self.operators(u_old, u_old1, params, aux=aux)
        delta = torch.zeros_like(u_old, dtype=ops.dtype)
        n = invert_blocks(ops.jacobian_blocks(delta), with_count=True)[1]
        if self.group is None:
            return n
        return int(self.group.all_reduce(torch.tensor(
            [n], device=self.group.device))[0])

    def step(self, u_guess, u_old, u_old1, aux: Dict, params: StepParams):
        """One attempted nonlinear solve at (t, dt) from
        delta = u_guess - u_old. With `NewtonConfig.host_loop` and no row
        scaling, the host loop (`newton_solve`): a `u_guess` that is
        another tensor than `u_old` is a predicted guess. Otherwise the
        whole-solve loop (`newton_krylov`). Returns (u_new, NewtonInfo)."""
        ops = self.operators(u_old, u_old1, params, aux=aux)
        delta = (u_guess - u_old).to(self.dtype)
        R_hi = None
        if self._hi_enabled() and not self.row_scaled:
            R_hi = self.operators(u_old, u_old1, params, torch.float64,
                                  aux).residual
        if self.row_scaled:
            delta, info = self._step_row_scaled(ops, delta, u_old)
        elif self.newton.host_loop:
            delta, info = newton_solve(
                ops.residual, ops.jacobian_action, delta, self.newton,
                self.block_precond_builder(ops), residual_hi=R_hi,
                predicted=u_guess is not u_old, dyn_atol=self.dyn_atol,
                group=self.group)
        else:
            delta, info = newton_krylov(
                ops.residual, ops.jacobian_action, delta, self.newton,
                self.block_precond_builder(ops), residual_hi=R_hi,
                group=self.group)
        return u_old + delta.to(u_old.dtype), info

    def _step_row_scaled(self, ops: StepOperators, delta, u_old):
        """`newton_krylov` on the row-equilibrated system w * R: the
        weights come from the row norms at the start, and a float32 system
        that sets no `stol` converges also on stol = 1e-3 (its achievable
        reduction is capped by assembly noise)."""
        newton = self.newton
        w = self.row_weights(ops, delta)
        if self.row_scaled_atol_rel > 0:
            atol = self.row_scaled_atol_rel * float(_norm(u_old.to(
                ops.dtype), self.group))
            newton = dataclasses.replace(newton, atol=max(newton.atol, atol))
        if ops.dtype == torch.float32 and newton.stol == 0.0:
            newton = dataclasses.replace(newton, stol=1e-3)

        def residual(d):
            return w * ops.residual(d)

        def jacobian_action(d):
            J = ops.jacobian_action(d)
            return lambda v: w * J(v)

        return newton_krylov(residual, jacobian_action, delta, newton,
                             self.block_precond_builder(ops, w),
                             group=self.group)


# -- B independent members of one system (batched parameter sweeps) ----------


class BatchedStepOperators(StepOperators):
    """`StepOperators` of a `BatchedSystem`: B members' states stacked as
    [B*n_dofs, n_eq] (member b's rows from b*n_dofs, a view of [B, n_dofs,
    n_eq]), the batches' elements repeated per member with the dofs
    offset, and each member's step parameters (t, dt, dt_old differ per
    member, so do the BDF2 coefficients) broadcast to its elements as
    [n_elems, 1] tensors in `ctx["params"]`. The Dirichlet values are each
    member's `values_at(t)`. Every element scatters into its own member's
    rows, so the members never mix."""

    def __init__(self, bsys: "BatchedSystem", u_old: torch.Tensor,
                 u_old1: torch.Tensor, params: StepParams, dtype,
                 aux: Optional[Dict] = None):
        B, n, ne = u_old.shape
        self.n_members = B
        self.n_dofs, self.n_eq = B * n, ne
        self.dtype = dtype
        self.mask = bsys.mask
        bcs = bsys.inner.bcs
        g = torch.stack([bcs.values_at(float(t)) for t in params.t])
        aux = {k: (v.repeat((B,) + (1,) * (v.dim() - 1))
                   if isinstance(v, torch.Tensor) and v.dim() >= 1
                   and v.shape[0] == n else v)
               for k, v in (aux or {}).items()}
        self._setup([(b.astype(dtype), k) for b, k in bsys.batches],
                    g.reshape(B * n, ne), u_old.reshape(B * n, ne),
                    u_old1.reshape(B * n, ne), params, aux)

    def _params_for(self, batch, p: StepParams) -> StepParams:
        per = batch.dofs.shape[0] // self.n_members
        return StepParams(*(x.repeat_interleave(per)[:, None] for x in p))


class BatchedSystem:
    """B independent members of one `CoupledSystem` (same mesh, model and
    configuration; own states, step parameters and Dirichlet values),
    solved together: one kernel call and one scatter launch per operation
    for the whole batch. The layout is the stacked numbering of the domain
    decomposition (`parallel.dd`) with B disconnected copies: each batch
    is a `local_view` of its elements repeated B times, member b's dofs
    offset by b*n_dofs, scattered by K1's dense in-place form (the cell
    batch, every row live) or its compact form (the facet batches, their
    live rows). The
    structured slice/pad path is not used. The Newton and Krylov loops
    carry a leading member axis (`newton_krylov_batched`) with per-member
    scalars, norms and stopping; the elliptic solve of the Poisson row
    takes the members as trailing right-hand sides.

    `step` is `vmap` of the JAX package's `CoupledSystem._step`: the
    whole-solve `newton_krylov` for every configuration, row equilibration
    (each member's own weights and absolute target) and the transport
    z-lines (every member's lines in one solve) included."""

    def __init__(self, system: CoupledSystem, n_members: int):
        self.inner = system
        self.n_members = B = int(n_members)
        self.n_eq = system.n_eq
        self.newton = system.newton
        n = system.n_dofs
        self.batches = []
        for batch, kernel in system._batches():
            arrays = {}
            for f in batch._SHARD_FIELDS:
                a = (batch.dofs_np if f == "dofs" else
                     getattr(batch, f).cpu().numpy())
                if f == "dofs":
                    off = (np.arange(B, dtype=np.int64) * n)[:, None, None]
                    a = (a[None].astype(np.int64) + off).reshape(
                        (-1,) + a.shape[1:])
                else:
                    a = np.concatenate([a] * B)
                arrays[f] = a
            self.batches.append((batch.local_view(arrays, B * n), kernel))
        self.mask = system.bcs.mask.repeat(B, 1)
        # the transport z-lines: member b's lines at its dofs b*n on, the
        # cell masks repeated for the B copies of the cell batch
        self._tzline = None
        if system._tzline is not None:
            eqs, grid, m_sub, m_sup = system._tzline
            off = torch.arange(B, device=grid.device) * n
            self._tzline = (eqs, (grid[None] + off[:, None, None]).reshape(
                -1, grid.shape[1]), m_sub.repeat(B, 1, 1),
                m_sup.repeat(B, 1, 1))

    @property
    def dtype(self):
        return self.inner.dtype

    def operators(self, u_old, u_old1, params: StepParams, dtype=None,
                  aux: Optional[Dict] = None) -> BatchedStepOperators:
        return BatchedStepOperators(self, u_old, u_old1, params,
                                    self.dtype if dtype is None else dtype,
                                    aux)

    def residual(self, u, u_old, u_old1, params: StepParams, dtype=None,
                 aux: Optional[Dict] = None) -> torch.Tensor:
        """Residuals [B, n_dofs, n_eq] at the absolute states `u`."""
        ops = self.operators(u_old, u_old1, params, dtype, aux)
        return ops.residual((u - u_old).reshape(ops.n_dofs, -1)
                            .to(ops.dtype)).reshape(u.shape)

    def block_precond_builder(self, ops: BatchedStepOperators,
                              row_weights: Optional[torch.Tensor] = None
                              ) -> Callable:
        """delta -> M on [B*n_dofs, n_eq]: `CoupledSystem`'s, every member's
        node blocks (and z-line solves) at once, and on the elliptic row
        one solve with the B members' columns as right-hand sides
        [n_dofs, B]."""
        B, inner = self.n_members, self.inner
        ell = None
        if inner._ell is not None:
            eq, solve = inner._ell

            def solve_members(r_eq):
                return solve(r_eq.reshape(B, -1).t()).t().reshape(-1)

            ell = (eq, solve_members)

        def tz_solver(blocks, sub, sup):
            return inner._tzline_solver(blocks, sub, sup, self._tzline[1])

        return _block_precond(ops, self._tzline, tz_solver, ell,
                              row_weights)

    def step(self, u_guess, u_old, u_old1, aux: Dict, params: StepParams,
             active: Optional[np.ndarray] = None):
        """One attempted nonlinear solve of every member from
        delta = u_guess - u_old ([B, n_dofs, n_eq], float64), at per-member
        StepParams of [B] arrays, by `newton_krylov_batched`; members
        outside `active` do not iterate. Returns (u_new, NewtonInfo of [B]
        arrays)."""
        shape = tuple(u_old.shape)
        flat = (shape[0] * shape[1], shape[2])
        ops = self.operators(u_old, u_old1, params, aux=aux)

        last = [None, -1, None]

        def view(d):
            # one view per iterate, so the operators' tangent cache (keyed
            # on the tensor) serves J v and the node blocks alike
            if last[0] is not d or last[1] != d._version:
                last[:] = [d, d._version, d.reshape(flat)]
            return last[2]

        def stacked(fn):
            return lambda d: fn(view(d)).reshape(shape)

        inner, newton = self.inner, self.newton
        delta = (u_guess - u_old).to(self.dtype)
        residual, jacobian_action = ops.residual, ops.jacobian_action
        R_hi = w = None
        kw = {}
        if inner.row_scaled:
            # `_step_row_scaled` of every member: the weights at the start,
            # each member's absolute target from its own state
            w = inner.row_weights(ops, view(delta))
            if inner.row_scaled_atol_rel > 0:
                kw["atol"] = np.maximum(newton.atol, np.array([
                    inner.row_scaled_atol_rel * float(_norm(
                        u_old[b].to(ops.dtype))) for b in range(shape[0])]))
            if ops.dtype == torch.float32 and newton.stol == 0.0:
                newton = dataclasses.replace(newton, stol=1e-3)

            def residual(d):
                return w * ops.residual(d)

            def jacobian_action(d):
                J = ops.jacobian_action(d)
                return lambda v: w * J(v)
        elif inner._hi_enabled():
            R_hi = stacked(self.operators(u_old, u_old1, params,
                                          torch.float64, aux).residual)
        pb = self.block_precond_builder(ops, w)
        delta, info = newton_krylov_batched(
            stacked(residual),
            lambda d: stacked(jacobian_action(view(d))),
            delta, newton, lambda d: stacked(pb(view(d))),
            residual_hi=R_hi, active=active, **kw)
        return u_old + delta.to(u_old.dtype), info
