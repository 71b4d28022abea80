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
from ..solvers.newton import NewtonConfig, newton_krylov, newton_solve
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
                     params=p)
            return c

        self.ctxs = [ctx(b) for b, _ in self.batches]
        # (delta, its version, per-batch tangents) of the last delta
        self._tangents = None

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """A state-layout tensor as the batches gather it."""
        return x

    def _out(self, r: torch.Tensor) -> torch.Tensor:
        """The batches' summed scatter as a state-layout tensor."""
        return r

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

    def _local_tangents(self, bi: int, delta: torch.Tensor):
        """(a, j, t) for every local tangent basis vector e_(a, j) of batch
        `bi`: t is the kernel's tangent [n_elems, n_local, n_eq] along it
        at `delta` (from `_all_tangents` with `element_jacobian`, else
        one forward-mode pass each)."""
        if self.element_jacobian:
            T = self._all_tangents(delta)[bi]
            for a in range(T.shape[2]):
                for j in range(self.n_eq):
                    yield a, j, T[a * self.n_eq + j]
            return
        (batch, kernel), ctx = self.batches[bi], self.ctxs[bi]
        u_e = batch.gather(self._in(delta))
        for a in range(u_e.shape[1]):
            for j in range(self.n_eq):
                tan = torch.zeros_like(u_e)
                tan[:, a, j] = 1.0
                yield a, j, _jvp(kernel, batch, ctx, u_e, tan)

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
            for a, j, t in self._local_tangents(bi, delta):
                diag[:, a, :, j] = t[:, a, :]
                if cross is not None and j in eqs:
                    k = eqs.index(j)
                    cross[:, :, k, 0] += m_sub[:, :, a] * t[:, :, j]
                    cross[:, :, k, 1] += m_sup[:, :, a] * t[:, :, j]
            blocks = batch.scatter_add(blocks, diag)
            if cross is not None:
                zc = batch.scatter_add(self._zeros(len(eqs), 2), cross)
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
        for bi, (batch, _) in enumerate(self.batches):
            contrib = None
            for _, _, t in self._local_tangents(bi, delta):
                contrib = t.abs() if contrib is None else contrib + t.abs()
            norms = batch.scatter_add(norms, contrib)
        return self._out(norms)


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

    def enable_elliptic_precond(self, eq: int, degree: int = 12,
                                ratio: float = 30.0, power_iters: int = 40,
                                mg=None, solver=None) -> None:
        """Replace the node-block answer on row `eq` by an approximate
        solve of that component's masked Laplacian: one V-cycle of `mg`
        (an object with `precond(r)`), any linear operator `solver`
        (r -> ~A^-1 r, e.g. `ZLineSmoother.solve`), or else a Chebyshev
        polynomial of the given degree in the Jacobi-scaled operator."""
        from ..solvers.chebyshev import chebyshev_solver, power_iteration_lmax
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
        A = self.masked_stiffness_op(eq)

        def At(x):
            return A(x) / dtilde

        lmax = power_iteration_lmax(At, self.n_dofs, iters=power_iters,
                                    device=mask.device)
        cheb = chebyshev_solver(At, lmax / ratio, 1.05 * lmax, degree)
        self._ell = (eq, lambda r: cheb(r / dtilde))

    def masked_stiffness_op(self, eq: int) -> Callable:
        """The masked Laplacian of component `eq` on [n_dofs] vectors
        (identity on Dirichlet rows), in the cell batch's type: the
        operator the elliptic preconditioners approximate."""
        mask = self.bcs.mask[:, eq]
        b = self.cell_batch

        def A(x):
            x_in = torch.where(mask, 0.0, x).to(b.dtype)
            Ax = b.scatter(b.stiffness(b.grad(b.gather(x_in))))
            return torch.where(mask, x, Ax)

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

    def _tzline_solver(self, blocks, sub, sup) -> Callable:
        """r [n_dofs, n_sel] -> the per-z-line tridiagonal solves with the
        exact (sub, diag, sup) couplings, diag from the node blocks."""
        eqs, grid = self._tzline[:2]
        flat = grid.reshape(-1)

        def solve(r):
            out = torch.empty_like(r)
            for k, e in enumerate(eqs):
                x = tridiag_solve_pcr(sub[:, k][grid], blocks[:, e, e][grid],
                                      sup[:, k][grid], r[:, k][grid])
                out[flat, k] = x.reshape(-1)
            return out

        return solve

    def _hi_enabled(self) -> bool:
        return self.newton.hi_residual and self.dtype != torch.float64

    def operators(self, u_old, u_old1, params: StepParams, dtype=None,
                  aux: Optional[Dict] = None) -> StepOperators:
        return StepOperators(self, u_old, u_old1, params,
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
        tz = self._tzline if row_weights is None else None

        def build(delta):
            if tz is not None:
                eqs, _, m_sub, m_sup = tz
                blocks, (sub, sup) = ops.jacobian_blocks(
                    delta, (eqs, m_sub, m_sup))
                tz_solve = self._tzline_solver(blocks, sub, sup)
            else:
                blocks = ops.jacobian_blocks(delta)
                tz_solve = None
            if row_weights is not None:
                blocks = row_weights[:, :, None] * blocks
            inv = invert_blocks(blocks)
            ell = self._ell

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

    def row_weights(self, ops: StepOperators,
                    delta: torch.Tensor) -> torch.Tensor:
        """1 / (assembled l1 row norm) at `delta`, 1 where that norm is 0
        or not finite and on Dirichlet rows."""
        rownorm = ops.row_l1(delta)
        w = torch.where((rownorm > 0) & torch.isfinite(rownorm),
                        1.0 / rownorm, 1.0)
        return torch.where(self.bcs.mask, 1.0, w).to(rownorm.dtype)

    def guarded_block_count(self, u_old, u_old1, params: StepParams,
                            aux: Optional[Dict] = None) -> int:
        """Diagnostic: how many node blocks at the state u_old (delta = 0)
        need the Jacobi fallback of `invert_blocks`. A handful is the
        expected underflow case; a systematic count is an assembly defect
        the fallback would otherwise hide."""
        ops = self.operators(u_old, u_old1, params, aux=aux)
        delta = torch.zeros_like(u_old, dtype=ops.dtype)
        return invert_blocks(ops.jacobian_blocks(delta), with_count=True)[1]

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
                predicted=u_guess is not u_old, dyn_atol=self.dyn_atol)
        else:
            delta, info = newton_krylov(
                ops.residual, ops.jacobian_action, delta, self.newton,
                self.block_precond_builder(ops), residual_hi=R_hi)
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
                ops.dtype)))
            newton = dataclasses.replace(newton, atol=max(newton.atol, atol))
        if ops.dtype == torch.float32 and newton.stol == 0.0:
            newton = dataclasses.replace(newton, stol=1e-3)

        def residual(d):
            return w * ops.residual(d)

        def jacobian_action(d):
            J = ops.jacobian_action(d)
            return lambda v: w * J(v)

        return newton_krylov(residual, jacobian_action, delta, newton,
                             self.block_precond_builder(ops, w))
