"""Damped Newton-Krylov: one iteration at a time, driven from the host.

Port of the JAX package's `solvers/newton.py` for the options the streamer
bench configures. The Jacobian action is supplied by the caller (forward-mode
AD of the element kernels, see `model.system`), the inner solve is
left-preconditioned BiCGStab with a GMRES(m) fallback, the line search is the
eager backtracking structure (full step probed first), and the convergence
verdict is SNES-style with the noise-floor stall acceptance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from .linear import _norm, bicgstab, gmres


@dataclass(frozen=True)
class NewtonConfig:
    """The JAX package's NewtonConfig fields that the port reads. The port
    always drives the nonlinear loop from the host (PyTorch runs eagerly),
    as the JAX package does with `host_loop=True`."""

    rtol: float = 1e-4
    atol: float = 0.0
    max_iter: int = 20
    linear_tol: float = 1e-4
    linear_maxiter: int = 300
    gmres_restart: int = 30
    # inner solves exit after this many iterations without a 1% residual
    # improvement; 0 disables
    linear_stall_window: int = 0
    # rerun a failed BiCGStab solve with GMRES(m) before the line search
    gmres_fallback: bool = True
    # per-component trust clamp on the Newton direction; () disables
    delta_clip: tuple = ()
    max_halvings: int = 6
    armijo: float = 1e-4
    max_stalls: int = 2
    # accept a stalled (or iteration-capped) solve that reduced ||F|| by at
    # least this factor; 0 disables
    accept_reduction: float = 0.0
    # float64 residual (Newton defect, line-search and convergence norms)
    # with the float32 Jacobian action and Krylov correction
    hi_residual: bool = False


class NewtonInfo(NamedTuple):
    converged: bool
    iters: int
    res_norm: float
    res0_norm: float
    lin_relres: float
    stall_accepted: bool = False


def newton_iteration(residual: Callable, jacobian_action: Callable,
                     u: torch.Tensor, fnorm: float, config: NewtonConfig,
                     precond_builder: Callable,
                     residual_hi: Optional[Callable] = None):
    """One damped Newton-Krylov iteration at the iterate `u`.

    `jacobian_action(u)` returns the map v -> J(u) v and
    `precond_builder(u)` the preconditioner r -> M^-1 r. `residual_hi`, when
    given, is a float64 evaluation of the same residual: it supplies the
    Newton right-hand side and every line-search norm (the incoming `fnorm`
    must come from it too).

    Returns (u_new, fnorm_new, linres, improved): `u_new`/`fnorm_new` keep
    the incoming iterate when the line search finds no reduction.
    """
    jvp = jacobian_action(u)
    f = (residual_hi(u).to(u.dtype) if residual_hi is not None
         else residual(u))
    res_ls = residual if residual_hi is None else residual_hi
    M = precond_builder(u)

    # left preconditioning: the Krylov tolerance becomes a per-row relative
    # accuracy on the log-form rows of wildly different scale
    def op(v):
        return M(jvp(v))

    rhs = M(-f)
    delta, linres, _ = bicgstab(
        op, rhs, tol=config.linear_tol, maxiter=config.linear_maxiter,
        stall_window=config.linear_stall_window)
    lr = float(linres)
    delta_ok = bool(torch.isfinite(delta).all())
    if config.gmres_fallback and (lr > config.linear_tol
                                  or not math.isfinite(lr) or not delta_ok):
        # a non-finite direction restarts GMRES from zero
        x0 = delta if delta_ok else torch.zeros_like(delta)
        delta, linres, _ = gmres(
            op, rhs, x0=x0, tol=config.linear_tol,
            maxiter=config.linear_maxiter, restart=config.gmres_restart,
            stall_window=config.linear_stall_window)
    if config.delta_clip:
        lim = torch.as_tensor(config.delta_clip, dtype=delta.dtype,
                              device=delta.device)
        delta = torch.clamp(delta, -lim, lim)

    # backtracking line search, the full step probed first
    lam, h = 1.0, 0
    fnew = float(_norm(res_ls(u + delta)))
    while (not fnew <= (1.0 - config.armijo * lam) * fnorm
           and h < config.max_halvings):
        lam *= 0.5
        fnew = float(_norm(res_ls(u + lam * delta)))
        h += 1
    # a non-reducing iteration keeps the better iterate (a stall)
    improved = math.isfinite(fnew) and fnew < fnorm
    if not improved:
        return u, fnorm, float(linres), False
    return u + lam * delta, fnew, float(linres), True


def newton_converged(fnorm: float, f0_norm: float, target: float,
                     stalls: int, config: NewtonConfig,
                     iter_capped: bool = False) -> bool:
    """Final verdict: ||F|| <= target, or — with `accept_reduction` — an
    exit on the stall limit or the iteration cap whose kept-best iterate
    still reduced ||F|| by that factor."""
    return math.isfinite(fnorm) and (
        fnorm <= target or _stall_accept(fnorm, f0_norm, stalls, config,
                                         iter_capped))


def _stall_accept(fnorm, f0_norm, stalls, config, iter_capped) -> bool:
    return (config.accept_reduction > 0
            and (stalls >= config.max_stalls or iter_capped)
            and fnorm <= config.accept_reduction * f0_norm)


def newton_solve(residual: Callable, jacobian_action: Callable,
                 delta: torch.Tensor, config: NewtonConfig,
                 precond_builder: Callable,
                 residual_hi: Optional[Callable] = None):
    """Solve residual(delta) = 0 from `delta`, one host-driven iteration at
    a time. Returns (delta, NewtonInfo)."""
    f0 = float(_norm(residual_hi(delta) if residual_hi is not None
                     else residual(delta)))
    target = max(config.rtol * f0, config.atol)
    fnorm, k, linres = f0, 0, math.inf
    stalls = 0 if math.isfinite(f0) else 99
    while (fnorm > target and k < config.max_iter
           and stalls < config.max_stalls and math.isfinite(fnorm)):
        delta, fnorm, linres, improved = newton_iteration(
            residual, jacobian_action, delta, fnorm, config,
            precond_builder, residual_hi)
        stalls = 0 if improved else stalls + 1
        k += 1
    capped = k >= config.max_iter
    converged = newton_converged(fnorm, f0, target, stalls, config, capped)
    strict = math.isfinite(fnorm) and fnorm <= target
    return delta, NewtonInfo(converged, k, fnorm, f0, linres,
                             converged and not strict)
