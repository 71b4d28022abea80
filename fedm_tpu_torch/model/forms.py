"""Weak-form building blocks for the plasma balance equations (increment
formulation), on gathered element values `[n_cells, n_local]` (the JAX
package's `model/forms.py`): the variable-step BDF2 time term, the
drift-diffusion flux, the balance and Poisson contributions, the
branch-free Min/Max and the boundary-flux dispatch. Every `abs` goes
through `abs_`, so forward-mode tangents are the JAX package's at 0.

Sign convention of the reference residual: F = time derivative - flux term
- source, with flux term = integral of Gamma . grad v (drift-diffusion) or
integral of -grad(D n) . grad v (diffusion).
"""

from __future__ import annotations

from typing import Optional

import torch


def bdf2_history_part(u_q, u_old_q, u_old1_q, dt, dt_old):
    """The ratio-weighted BDF2 combination
    (u*(1+2r) - (1+r)^2 u_old + r^2 u_old1)/(1+r), r = dt/dt_old
    (`fedm/functions.py:349-357`); dt_old >> dt degrades it to the BDF1
    difference u - u_old, the reference's bootstrap."""
    tr = dt / dt_old
    trp1 = 1.0 + tr
    tr2p1 = 1.0 + 2.0 * tr
    return (u_q * tr2p1 - trp1 * trp1 * u_old_q + tr * tr * u_old1_q) / trp1


def drift_diffusion_flux(batch, u_e: torch.Tensor, D_e: torch.Tensor,
                         mu_e: torch.Tensor, E_q: torch.Tensor, sign: float,
                         grad_diffusion: bool = True,
                         log_representation: bool = True) -> torch.Tensor:
    """Particle flux at quadrature points [n_cells, n_q, dim]
    (`fedm/functions.py:219-237`):

      Gamma = -grad(D n) + sign mu E n   (grad_diffusion=True)
      Gamma = -D grad(n) + sign mu E n   (grad_diffusion=False)

    with n = exp(u) under `log_representation`. D_e, mu_e are gathered
    nodal coefficients; E_q is the field at the quadrature points."""
    u_q = batch.value(u_e)
    D_q = batch.value(D_e)
    mu_q = batch.value(mu_e)
    gu_q = batch.grad(u_e)
    if log_representation:
        n_q = torch.exp(u_q)
        gn_q = n_q[..., None] * gu_q  # grad e^u = e^u grad u
    else:
        n_q = u_q
        gn_q = gu_q
    if grad_diffusion:
        diffusion = -(batch.grad(D_e) * n_q[..., None]
                      + D_q[..., None] * gn_q)
    else:
        diffusion = -D_q[..., None] * gn_q
    return diffusion + sign * mu_q[..., None] * E_q * n_q[..., None]


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
                             D_e: Optional[torch.Tensor] = None,
                             log_representation: bool = True):
    """Residual contribution [n_cells, n_local] of one balance equation,
    in log form (n = exp(u)) by default, else in the density itself: time
    term minus flux term minus source.

    equation_type: 'reaction' | 'diffusion-reaction' |
    'drift-diffusion-reaction'. For diffusion-reaction the flux -grad(D n)
    is built here from D_e; for drift-diffusion-reaction pass Gamma_q."""
    u_q = batch.value(u_old_e) + batch.value(delta_e)
    u_part = bdf2_increment_part(batch.value(delta_e),
                                 batch.value(d_hist_e), dt, dt_old)
    weight = torch.exp(u_q) if log_representation else 1.0
    contrib = batch.mass(weight * u_part / dt)
    if equation_type == "diffusion-reaction":
        if D_e is None:
            raise ValueError("diffusion-reaction requires D_e")
        u_e = u_old_e + delta_e
        n_q = torch.exp(u_q) if log_representation else u_q
        gu_q = batch.grad(u_e)
        gn_q = n_q[..., None] * gu_q if log_representation else gu_q
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



def Min(a, b):
    """Branch-free minimum (a + b - |a - b|)/2
    (`fedm/functions.py:212-216`)."""
    return (a + b - abs_(a - b)) / 2.0


def poisson_contrib(batch, phi_e: torch.Tensor,
                    f_q: torch.Tensor) -> torch.Tensor:
    """Poisson residual contribution: integral of grad(Phi) . grad v minus
    integral of f v (`fedm/functions.py:379-401`)."""
    return batch.stiffness(batch.grad(phi_e)) - batch.mass(f_q)


def boundary_flux(fb, bc_type: str, equation_type: str, particle_type: str,
                  sign: float, mu_q, En_q, u_q, gamma: float,
                  r_coeff: float = 1.0, vth=0.0, Ion_flux=0.0):
    """The reference's `Boundary_flux` surface term
    (`fedm/functions.py:404-528`): the integrand at facet quadrature
    points (to be passed to `fb.mass`), or 0.0 where the combination adds
    nothing ('zero flux', or 'Neumann' with a non-drift equation).

    mu_q is the (possibly semi-implicit) mobility, En_q = E . n, u_q the
    log-density, vth the thermal velocity (number or field), Ion_flux the
    positive ion outflux for secondary emission."""
    bc_types = ("zero flux", "flux source", "Neumann")
    bc_type = bc_type.replace("_", " ")
    if bc_type not in bc_types:
        raise ValueError(
            f"boundary condition type '{bc_type}' not recognised; must be "
            f"one of {bc_types}")
    equation_types = ("reaction", "diffusion-reaction",
                      "drift-diffusion-reaction")
    if bc_type != "zero flux" and equation_type not in equation_types:
        raise ValueError(
            f"equation type '{equation_type}' not recognised; must be one "
            f"of {equation_types}")
    if bc_type == "flux source" and equation_type != "reaction":
        if (equation_type == "diffusion-reaction"
                and particle_type not in ("Heavy", "electrons")):
            raise ValueError(
                f"particle type '{particle_type}' not recognised; must be "
                "'Heavy' or 'electrons'")
        result = (1.0 - r_coeff) / (1.0 + r_coeff)
        if equation_type == "diffusion-reaction":
            result = result * 0.5 * vth * torch.exp(u_q)
        if equation_type == "drift-diffusion-reaction":
            result = result * (0.5 * vth + abs_(sign * mu_q * En_q)) \
                * torch.exp(u_q)
            if particle_type == "electrons":
                result = result - 2.0 * gamma * Ion_flux / (1.0 + r_coeff)
        return result
    if bc_type == "Neumann" and equation_type == "drift-diffusion-reaction":
        return sign * mu_q * En_q * torch.exp(u_q)
    return 0.0
