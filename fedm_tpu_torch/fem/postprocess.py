"""Post-processing helpers, the JAX package's `fem/postprocess.py`: the
facet normal projected onto the nodal space (the reference's
`Normal_vector`, `fedm/functions.py:1133-1151`) and the boundary flux
recovered by the consistency-term trick (its `BoundaryGradient`,
`fedm/functions.py:1164-1208`).
"""

from __future__ import annotations

import torch

from ..solvers.linear import cg
from .assembly import CellBatch, FacetBatch
from .space import FunctionSpace


def _boundary_mass(fb: FacetBatch):
    """(M_b x restricted to the boundary rows, identity elsewhere; the
    boundary rows mask; the lumped diagonal, 1 off the boundary)."""
    ones = torch.ones((fb.scale.shape[0], fb.n_q), dtype=fb.dtype,
                      device=fb.device)
    lump = fb.scatter(fb.mass(ones))
    on_b = lump > 0
    diag = torch.where(on_b, lump, 1.0)

    def op(x):
        x_in = torch.where(on_b, x, 0.0)
        return torch.where(on_b, fb.scatter(fb.mass(fb.value(
            fb.gather(x_in)))), x)

    return op, on_b, diag


def normal_vector(space: FunctionSpace, quad_degree: int = 4,
                  axisymmetric: bool = False, *, device) -> torch.Tensor:
    """The boundary facet normal projected onto the nodal space: M_b n = b
    with M_b the boundary mass matrix and b = boundary integral of n phi_a,
    solved by CG per component (interior rows solve to 0 and are masked).
    Returns [n_dofs, dim] nodal normals, zero off the boundary."""
    fb = FacetBatch(space, markers=None, quad_degree=quad_degree,
                    axisymmetric=axisymmetric, device=device)
    op, on_b, diag = _boundary_mass(fb)
    out = []
    for d in range(space.mesh.dim):
        b = fb.scatter(fb.mass(fb.normal[:, None, d].expand(
            fb.scale.shape[0], fb.n_q)))
        x, _, _ = cg(op, torch.where(on_b, b, 0.0),
                     precond=lambda r: r / diag, tol=1e-10, maxiter=500)
        out.append(torch.where(on_b, x, 0.0))
    return torch.stack(out, dim=-1)


def boundary_gradient(batch: CellBatch, space: FunctionSpace,
                      var: torch.Tensor, source_q: torch.Tensor,
                      extract_markers, epsilon: float = 8.854187817e-12,
                      quad_degree: int = 4, axisymmetric: bool = False,
                      tol: float = 1e-10) -> torch.Tensor:
    """The normal boundary flux (e.g. the field at an electrode) by the
    consistency-term trick: on the extraction boundary solve
    M_b E = -res / eps, with res = eps * integral grad(var) . grad v - integral
    f v the volume residual of the Poisson equation restricted to test
    functions supported at the boundary, which converges at the rate of
    the volume discretisation rather than of the raw gradient trace.
    Returns nodal values on the extraction boundary, zero elsewhere."""
    res = epsilon * batch.scatter(batch.stiffness(
        batch.grad(batch.gather(var)))) - batch.scatter(batch.mass(source_q))
    fb = FacetBatch(space, markers=extract_markers, quad_degree=quad_degree,
                    axisymmetric=axisymmetric, device=batch.device)
    op, on_b, diag = _boundary_mass(fb)
    rhs = torch.where(on_b, -res / epsilon, 0.0)
    E, _, _ = cg(op, rhs, precond=lambda r: r / diag, tol=tol, maxiter=1000)
    return torch.where(on_b, E, 0.0)
