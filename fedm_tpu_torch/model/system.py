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
scatter are linear, so the Jacobian action is
J v = scatter(jvp(kernel)(gather(v))): forward-mode
AD runs only through the plain-torch element kernels, never through the
scatter (whose ELL branch is an opaque CUDA kernel). The node-block Jacobi
preconditioner pushes the n_local*n_eq local tangent basis vectors through
the kernels the same way and keeps the same-node blocks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.forward_ad as fwAD

from ..fem.assembly import CellBatch, FacetBatch
from ..fem.dirichlet import BCSet
from ..solvers.newton import NewtonConfig, newton_solve
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
        self.batches = [(b.astype(dtype), k) for b, k in system._batches()]
        d_hist = (u_old - u_old1).to(dtype)
        self.bc_shift = (u_old - system.bcs.values_at(params.t)).to(dtype)
        u_old_c = u_old.to(dtype)
        p = StepParams(*(torch.tensor(x, dtype=dtype, device=u_old.device)
                         for x in params))

        def cast(v):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v.to(dtype)
            return v

        aux_c = {k: cast(v) for k, v in (aux or {}).items()}

        def ctx(b):
            def maybe_gather(v):
                if (isinstance(v, torch.Tensor) and v.dim() >= 1
                        and v.shape[0] == self.n_dofs):
                    return b.gather(v)
                return v

            c = {name: maybe_gather(v) for name, v in aux_c.items()}
            c.update(u_old=b.gather(u_old_c), d_hist=b.gather(d_hist),
                     params=p)
            return c

        self.ctxs = [ctx(b) for b, _ in self.batches]

    def _zeros(self, *trailing):
        return torch.zeros((self.n_dofs,) + trailing, dtype=self.dtype,
                           device=self.mask.device)

    def residual(self, delta: torch.Tensor) -> torch.Tensor:
        """R(delta), Dirichlet rows delta + (u_old - g)."""
        delta = delta.to(self.dtype)
        out = self._zeros(self.n_eq)
        for (batch, kernel), ctx in zip(self.batches, self.ctxs):
            out = batch.scatter_add(
                out, kernel(batch, batch.gather(delta), ctx))
        return torch.where(self.mask, delta + self.bc_shift, out)

    def jacobian_action(self, delta: torch.Tensor) -> Callable:
        """v -> J(delta) v (Dirichlet rows identity)."""
        lin = [(batch, ctx, batch.gather(delta), kernel)
               for (batch, kernel), ctx in zip(self.batches, self.ctxs)]

        def apply(v: torch.Tensor) -> torch.Tensor:
            out = self._zeros(self.n_eq)
            for batch, ctx, u_e, kernel in lin:
                t = _jvp(kernel, batch, ctx, u_e, batch.gather(v))
                out = batch.scatter_add(out, t)
            return torch.where(self.mask, v, out)

        return apply

    def jacobian_blocks(self, delta: torch.Tensor) -> torch.Tensor:
        """Exact per-dof diagonal blocks B[n, i, j] = dR_i/d delta_j at dof n
        [n_dofs, n_eq, n_eq]; Dirichlet rows are identity rows."""
        ne = self.n_eq
        blocks = self._zeros(ne, ne)
        for (batch, kernel), ctx in zip(self.batches, self.ctxs):
            u_e = batch.gather(delta)
            n_elems, nl = u_e.shape[:2]
            # diag[c, a, i, j] = d contrib(c, a, i) / d u_e(c, a, j)
            diag = torch.empty((n_elems, nl, ne, ne), dtype=self.dtype,
                               device=u_e.device)
            for a in range(nl):
                for j in range(ne):
                    tan = torch.zeros_like(u_e)
                    tan[:, a, j] = 1.0
                    diag[:, a, :, j] = _jvp(kernel, batch, ctx, u_e,
                                            tan)[:, a, :]
            blocks = batch.scatter_add(blocks, diag)
        eye = torch.eye(ne, dtype=self.dtype, device=blocks.device)
        return torch.where(self.mask[:, :, None], eye, blocks)


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
        # absolute Newton target set by the driver (its floor_atol)
        self.dyn_atol = 0.0

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

    def enable_elliptic_precond(self, eq: int, mg) -> None:
        """Replace the node-block answer on row `eq` by one V-cycle of `mg`
        (an object with `precond(r)`), the Poisson-block preconditioner."""
        self._ell = (eq, mg.precond)

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

    def block_precond_builder(self, ops: StepOperators) -> Callable:
        """delta -> M, with M^-1 the inverted node blocks and, on the
        elliptic row, the V-cycle."""
        def build(delta):
            inv = invert_blocks(ops.jacobian_blocks(delta))
            ell = self._ell

            def M(r):
                y = block_apply(inv, r)
                if ell is not None:
                    eq, solve = ell
                    y[:, eq] = solve(r[:, eq])
                return y

            return M

        return build

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
        """One attempted nonlinear solve at (t, dt): Newton from
        delta = u_guess - u_old. A `u_guess` that is another tensor than
        `u_old` is a predicted guess (see `newton_solve`). Returns
        (u_new, NewtonInfo)."""
        ops = self.operators(u_old, u_old1, params, aux=aux)
        R_hi = None
        if self._hi_enabled():
            R_hi = self.operators(u_old, u_old1, params, torch.float64,
                                  aux).residual
        delta = (u_guess - u_old).to(self.dtype)
        delta, info = newton_solve(ops.residual, ops.jacobian_action, delta,
                                   self.newton,
                                   self.block_precond_builder(ops),
                                   residual_hi=R_hi,
                                   predicted=u_guess is not u_old,
                                   dyn_atol=self.dyn_atol)
        return u_old + delta.to(u_old.dtype), info
