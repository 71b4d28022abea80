"""Linear elliptic (Poisson) solves with Dirichlet lifting, the JAX
package's `solvers/elliptic.py`: a symmetrically masked, preconditioned CG
on the matrix-free stiffness operator.

The masked operator Op(v) = P_bc v + P_free A P_free v is SPD whenever A
is, so CG applies; Dirichlet data enters through the lifting u = g + z with
z = 0 on the boundary.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..fem.assembly import CellBatch
from .linear import cg


def _promoted(batch: CellBatch, x: torch.Tensor) -> CellBatch:
    """The batch in the promoted type of its tables and `x`: a float32
    batch meets float64 values in float64 arithmetic on its float32
    tables, as the JAX package's mixed-type einsums do."""
    return batch.astype(torch.promote_types(batch.dtype, x.dtype))


def stiffness_diagonal(batch: CellBatch,
                       coeff_q: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Diagonal of the (coefficient-weighted) stiffness matrix [n_dofs]."""
    g2 = torch.sum(batch.grads * batch.grads, dim=-1)  # [c, 1, n_local]
    scale = batch.scale if coeff_q is None else batch.scale * coeff_q
    contrib = scale.sum(dim=1)[:, None] * g2[:, 0]  # affine P1: q-free
    return batch.scatter(contrib)


def solve_poisson(batch: CellBatch, f_q: torch.Tensor, mask: torch.Tensor,
                  g: torch.Tensor, coeff_q: Optional[torch.Tensor] = None,
                  x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
                  maxiter: int = 2000,
                  precond: Optional[Callable] = None, slabs=None):
    """Solve integral(c grad u . grad v) = integral(f v) with u = g on the
    `mask` dofs.

    f_q, coeff_q: values at quadrature points [n_cells, n_q]; mask, g:
    [n_dofs]. `precond` (r -> ~A^-1 r, e.g. the structured multigrid's
    V-cycle) replaces the default Jacobi, which can exhaust `maxiter` on
    anisotropic corridor meshes. Each operator application runs in the
    promoted type of the batch and its operand. With `slabs`
    (`parallel.slabs.Slabs`) the batch is this rank's slab view, mask, g
    and the solution are its node rows, and CG reduces over the slabs'
    group. Returns (u, relres, iters)."""
    if slabs is None:
        fill = keep = (lambda x: x)
    else:
        fill, keep = slabs.fill, (lambda r: r[slabs.own_ext])

    def A(x):
        bx = _promoted(batch, x)
        G = bx.grad(bx.gather(fill(x)))  # [c, q, dim]
        if coeff_q is not None:
            G = G * coeff_q[:, :, None]
        return keep(bx.scatter(bx.stiffness(G)))

    def op(v):
        return torch.where(mask, v, A(torch.where(mask, 0.0, v)))

    g_ext = torch.where(mask, g, 0.0)
    bf = _promoted(batch, f_q)
    b = keep(bf.scatter(bf.mass(f_q)))
    rhs = torch.where(mask, 0.0, b - A(g_ext))

    diag = keep(stiffness_diagonal(batch, coeff_q))
    diag = torch.where(mask | (diag == 0), 1.0, diag)

    z0 = None if x0 is None else torch.where(mask, 0.0, x0 - g_ext)
    M = precond if precond is not None else (lambda r: r / diag)
    z, relres, iters = cg(op, rhs, x0=z0, precond=M, tol=tol,
                          maxiter=maxiter,
                          group=None if slabs is None else slabs.group)
    return g_ext + torch.where(mask, 0.0, z), relres, iters
