"""Chebyshev polynomial smoothing for the elliptic (Poisson) block (the JAX
package's `solvers/chebyshev.py`): a fixed-degree polynomial in the
Jacobi-scaled Laplacian, no data-dependent control flow, so the V-cycle it
smooths stays a fixed linear operator."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .linear import combine_norms


def power_iteration_lmax(matvec: Callable, n: int, iters: int = 50,
                         seed: int = 0, device="cpu", rows=None,
                         group=None) -> float:
    """Largest-eigenvalue estimate of a (scaled) SPD operator after a fixed
    `iters` iterations, from the float64 start vector
    `np.random.default_rng(seed).standard_normal(n)` of the JAX package
    (its last bits set every smoother built on the estimate). Over a
    `group` (`parallel.ranks`), `matvec` maps this rank's `rows` (a slice
    of the n) and the norm is summed over the ranks: each rank starts from
    its rows of the same global vector, so the estimate is the JAX
    package's up to the order of the norm's sum."""
    x = np.random.default_rng(seed).standard_normal(n)
    if rows is not None:
        x = x[rows]
    x = torch.as_tensor(x, dtype=torch.float64, device=device)
    lam = 1.0
    for _ in range(iters):
        y = matvec(x)
        lam = float(combine_norms(torch.linalg.vector_norm(y), group))
        x = y / lam
    return lam


def chebyshev_solver(matvec: Callable, lmin: float, lmax: float,
                     degree: int) -> Callable:
    """z ~= A^-1 r by the Chebyshev iteration on the spectrum [lmin, lmax]
    (the standard smoother recurrence, unrolled `degree` times); `matvec`
    is the (Jacobi-scaled) operator the spectrum refers to."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def solve(r: torch.Tensor) -> torch.Tensor:
        d = r / theta
        z = d
        rho_old = 1.0 / sigma1
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            d = rho * rho_old * d + (2.0 * rho / delta) * (r - matvec(z))
            z = z + d
            rho_old = rho
        return z

    return solve


class ChebyshevSolve:
    """The Chebyshev Poisson-row solve (`CoupledSystem.
    enable_elliptic_precond` without `mg` or `solver`): z ~= A^-1 r by a
    `degree` polynomial in the Jacobi-scaled operator A / dtilde on the
    spectrum [lmax / ratio, 1.05 lmax]. `A` maps [n] or [n, B] vectors;
    `dtilde` [n] is the Jacobi diagonal (1 on Dirichlet rows and zero
    diagonals); `lmax` the power iteration's estimate (`build`). What it
    holds is read by its z-slab form (`parallel.slabs.SlabChebyshev`)."""

    def __init__(self, A: Callable, dtilde: torch.Tensor, lmax: float,
                 degree: int, ratio: float):
        self.A, self.dtilde = A, dtilde
        self.lmax, self.degree, self.ratio = float(lmax), int(degree), ratio
        self._cheb = chebyshev_solver(self.At, self.lmax / ratio,
                                      1.05 * self.lmax, self.degree)

    @classmethod
    def build(cls, A: Callable, dtilde: torch.Tensor, degree: int,
              ratio: float, power_iters: int) -> "ChebyshevSolve":
        """The solve with `lmax` from `power_iteration_lmax` of A / dtilde
        over all its rows."""
        def At(x):
            return A(x) / _like(dtilde, x)

        lmax = power_iteration_lmax(At, dtilde.shape[0], iters=power_iters,
                                    device=dtilde.device)
        return cls(A, dtilde, lmax, degree, ratio)

    def At(self, x: torch.Tensor) -> torch.Tensor:
        """The Jacobi-scaled operator A x / dtilde."""
        return self.A(x) / _like(self.dtilde, x)

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        return self._cheb(r / _like(self.dtilde, r))


def _like(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`d` [n] shaped to divide `x` [n, ...]."""
    return d.reshape(d.shape + (1,) * (x.dim() - 1))
