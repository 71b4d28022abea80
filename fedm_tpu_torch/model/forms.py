"""Weak-form building blocks for the plasma balance equations (increment
formulation), on gathered element values `[n_cells, n_local]` (the JAX
package's `model/forms.py`).

Sign convention of the reference residual: F = time derivative - flux term
- source, with flux term = integral of Gamma . grad v (drift-diffusion) or
integral of -grad(D n) . grad v (diffusion).
"""

from __future__ import annotations

from typing import Optional

import torch


def bdf2_increment_part(delta_q, d_hist_q, dt, dt_old):
    """The ratio-weighted variable-step BDF2 combination in increments:
    with delta = u - u_old and d_hist = u_old - u_old1 it reads
    ((1+2r) delta - r^2 d_hist)/(1+r), r = dt/dt_old; dt_old >> dt
    degrades it to the BDF1 difference (`fedm/functions.py:349-368`)."""
    tr = dt / dt_old
    trp1 = 1.0 + tr
    tr2p1 = 1.0 + 2.0 * tr
    return (delta_q * tr2p1 - tr * tr * d_hist_q) / trp1


def balance_equation_contrib(batch, equation_type: str,
                             delta_e: torch.Tensor, u_old_e: torch.Tensor,
                             d_hist_e: torch.Tensor, dt, dt_old,
                             f_q: torch.Tensor,
                             Gamma_q: Optional[torch.Tensor] = None,
                             D_e: Optional[torch.Tensor] = None):
    """Residual contribution [n_cells, n_local] of one log-form balance
    equation (n = exp(u)): time term minus flux term minus source.

    equation_type: 'reaction' | 'diffusion-reaction' |
    'drift-diffusion-reaction'. For diffusion-reaction the flux -grad(D n)
    is built here from D_e; for drift-diffusion-reaction pass Gamma_q."""
    u_q = batch.value(u_old_e) + batch.value(delta_e)
    u_part = bdf2_increment_part(batch.value(delta_e),
                                 batch.value(d_hist_e), dt, dt_old)
    contrib = batch.mass(torch.exp(u_q) * u_part / dt)
    if equation_type == "diffusion-reaction":
        if D_e is None:
            raise ValueError("diffusion-reaction requires D_e")
        u_e = u_old_e + delta_e
        n_q = torch.exp(u_q)
        gn_q = n_q[..., None] * batch.grad(u_e)
        gD_q = batch.grad(D_e)
        D_q = batch.value(D_e)
        Gamma_q = -(gD_q * n_q[..., None] + D_q[..., None] * gn_q)
        contrib = contrib - batch.stiffness(Gamma_q)
    elif equation_type == "drift-diffusion-reaction":
        if Gamma_q is None:
            raise ValueError("drift-diffusion-reaction requires Gamma_q")
        contrib = contrib - batch.stiffness(Gamma_q)
    elif equation_type != "reaction":
        raise ValueError(
            f"equation type '{equation_type}' not recognised; options are "
            "'reaction', 'diffusion-reaction', 'drift-diffusion-reaction'")
    return contrib - batch.mass(f_q)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """|x| with the JAX package's tangent at 0: `jnp.abs` differentiates as
    select(x >= 0, t, -t), so +t at x = 0 (and at -0.0), where `torch.abs`
    gives 0. The electrode fluxes sit exactly there at zero field."""
    return torch.where(x >= 0, x, -x)


def Max(a, b):
    """Branch-free maximum (a + b + |a - b|)/2, the reference's smooth form
    (`fedm/functions.py:205-209`), e.g. the positive ion outflux."""
    return (a + b + abs_(a - b)) / 2.0

