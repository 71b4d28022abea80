"""Source terms from the reaction matrices (the JAX package's
`chemistry/sources.py`):

  rate_j = k_j * prod_i n_i^(p_ji),   n = [N0, exp(u_1), ...]
  f_i    = sum_j rate_j * (g_ji - l_ji)   (the model's rates @ (G - L))

In the log representation the power-law product is a matrix product,
rate = k * exp(ln_n @ P^T), and forward-mode AD differentiates through it
for the Jacobian action. Energy losses use the reference's sentinel
encodings: Uin in (7e77, 8e77) means the reaction deposits
(Ei - mean_energy); Uin in (9e99, 1e100) means it removes mean_energy;
anything else is a fixed loss in eV.
"""

from __future__ import annotations

from typing import Sequence

import torch


def reaction_rates(k: torch.Tensor, power_matrix,
                   ln_n: torch.Tensor) -> torch.Tensor:
    """rate_j = k_j * prod_i n_i^p_ji as k * exp(ln_n @ P^T); k [..., n_r],
    ln_n [..., n_sp] (the background gas in column 0) -> [..., n_r].
    `power_matrix` [n_r, n_sp] is copied to `ln_n`'s device and type unless
    it is already a tensor there (as the model keeps it).
    exp(x) can overflow float32 as an intermediate (N0 * n_e ~ 2e38 for a
    two-body rate) while k * exp(x) is moderate, so it is taken as
    (k * exp(x/2)) * exp(x/2)."""
    P = torch.as_tensor(power_matrix, dtype=ln_n.dtype, device=ln_n.device)
    x = ln_n @ P.T
    half = torch.exp(0.5 * x)
    return (k * half) * half


def species_sources(rates: torch.Tensor, loss_matrix,
                    gain_matrix) -> torch.Tensor:
    """f_i = sum_j rate_j (g_ji - l_ji): rates [..., n_r] -> [..., n_sp];
    the matrices [n_r, n_sp] are copied to `rates`' device and type."""
    def mat(a):
        return torch.as_tensor(a, dtype=rates.dtype, device=rates.device)

    return rates @ (mat(gain_matrix) - mat(loss_matrix))


def energy_source_factors(u_loss: Sequence[float], mean_energy: torch.Tensor,
                          Ei: float = 0.0) -> torch.Tensor:
    """Per-reaction energy-loss factor [..., n_r]; the energy source is then
    -(rates * factors).sum(-1). The sentinel branches are resolved per
    reaction on the host (u_loss is static)."""
    cols = []
    for loss in u_loss:
        if 7e77 < loss < 8e77:
            cols.append(Ei - mean_energy)
        elif 9e99 < loss < 1e100:
            cols.append(mean_energy + 0.0)
        else:
            cols.append(torch.full_like(mean_energy, loss))
    return torch.stack(cols, dim=-1)


def semi_implicit_coefficient(k: torch.Tensor, dk: torch.Tensor,
                              mean_energy_lin: torch.Tensor,
                              mean_energy_old: torch.Tensor) -> torch.Tensor:
    """Semi-implicit linearisation of an energy-dependent coefficient,
    k_si = k + (dk/d eps)(eps_lin - eps_old) (the reference's
    `functions.py:753-774`); `mean_energy_lin` may depend on the trial
    state, and forward-mode AD then carries this term into the Jacobian
    action, as the reference's UFL expression does."""
    return k + dk * (mean_energy_lin - mean_energy_old)
