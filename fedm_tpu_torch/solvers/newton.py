"""Damped Newton-Krylov: one iteration at a time, driven from the host.

Port of the JAX package's `solvers/newton.py` with its host-driven loop
(`model/system.py` `_step_host`). The Jacobian action is supplied by the
caller (forward-mode AD of the element kernels, see `model.system`); the
inner solve is left-preconditioned BiCGStab with a GMRES(m) fallback and
the optional true-residual rescue, or GMRES(m); the line search is the
eager backtracking structure (full step probed first); the verdict is
SNES-style (rtol/atol) with the noise-floor stall acceptance.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from .linear import _norm, bicgstab, gmres

LINEAR_SOLVERS = ("bicgstab", "gmres")


@dataclass(frozen=True)
class NewtonConfig:
    """The JAX package's NewtonConfig fields that the port reads. The port
    always drives the nonlinear loop from the host (PyTorch runs eagerly),
    as the JAX package does with `host_loop=True`."""

    rtol: float = 1e-4
    atol: float = 0.0
    max_iter: int = 20
    linear_solver: str = "bicgstab"
    linear_tol: float = 1e-4
    linear_maxiter: int = 300
    gmres_restart: int = 30
    # inner solves exit after this many iterations without a 1% residual
    # improvement; 0 disables
    linear_stall_window: int = 0
    # rerun a failed BiCGStab solve with GMRES(m) before the line search
    gmres_fallback: bool = True
    # when the BiCGStab direction's true-norm linear reduction
    # ||f + J d|| / ||f|| exceeds this, rerun right-preconditioned GMRES and
    # keep the better direction; only on an iteration whose line search
    # did not improve (the JAX package's host-loop lazy rescue). 0 disables
    true_res_rescue: float = 0.0
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

    def __post_init__(self):
        if self.linear_solver not in LINEAR_SOLVERS:
            raise ValueError(f"linear_solver {self.linear_solver!r}; options "
                             f"are {LINEAR_SOLVERS}")


class NewtonInfo(NamedTuple):
    converged: bool
    iters: int
    res_norm: float
    res0_norm: float
    lin_relres: float
    stall_accepted: bool = False


def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def _direction(jvp: Callable, f: torch.Tensor, M: Callable,
               config: NewtonConfig):
    """The Krylov solve of J d = -f: (d, linear relative residual)."""
    # left preconditioning: the Krylov tolerance becomes a per-row relative
    # accuracy on the log-form rows of wildly different scale
    def op(v):
        return M(jvp(v))

    rhs = M(-f)
    kw = dict(tol=config.linear_tol, maxiter=config.linear_maxiter,
              stall_window=config.linear_stall_window)
    if config.linear_solver == "gmres":
        d, linres, _ = gmres(op, rhs, restart=config.gmres_restart, **kw)
        return d, float(linres)
    d, linres, _ = bicgstab(op, rhs, **kw)
    lr = float(linres)
    d_ok = _finite(d)
    if config.gmres_fallback and (lr > config.linear_tol
                                  or not math.isfinite(lr) or not d_ok):
        # a non-finite direction restarts GMRES from zero
        x0 = d if d_ok else torch.zeros_like(d)
        d, linres, _ = gmres(op, rhs, x0=x0, restart=config.gmres_restart,
                             **kw)
        lr = float(linres)
    if config.true_res_rescue > 0:
        d = _true_res_rescue(jvp, f, M, d, config)
    return d, lr


def _true_res_rescue(jvp, f, M, d, config: NewtonConfig) -> torch.Tensor:
    """Keep `d`, or the right-preconditioned GMRES direction when `d`
    does not reduce the true linear residual by `true_res_rescue` and the
    GMRES one reduces it more."""
    f_n = _norm(f)
    lt0 = float(_norm(f + jvp(d)) / f_n)
    if math.isfinite(lt0) and lt0 <= config.true_res_rescue:
        return d
    y, _, _ = gmres(lambda v: jvp(M(v)), -f, tol=config.linear_tol,
                    maxiter=config.linear_maxiter,
                    restart=config.gmres_restart,
                    stall_window=config.linear_stall_window)
    d2 = M(y)
    if _finite(d2):
        lt2 = float(_norm(f + jvp(d2)) / f_n)
    else:
        d2, lt2 = torch.zeros_like(d2), math.inf
    return d2 if (lt2 < lt0 or not math.isfinite(lt0)) else d


def newton_iteration(residual: Callable, jacobian_action: Callable,
                     u: torch.Tensor, fnorm: float, config: NewtonConfig,
                     precond_builder: Callable,
                     residual_hi: Optional[Callable] = None):
    """One damped Newton-Krylov iteration at the iterate `u`.

    `jacobian_action(u)` returns the map v -> J(u) v and
    `precond_builder(u)` the preconditioner r -> M^-1 r. `residual_hi`,
    when given, is a float64
    evaluation of the same residual: it supplies the Newton right-hand side
    and every line-search norm (the incoming `fnorm` must come from it too).

    Returns (u_new, fnorm_new, linres, improved): `u_new` and `fnorm_new`
    keep the incoming iterate when the line search finds no reduction.
    """
    jvp = jacobian_action(u)
    f = (residual_hi(u).to(u.dtype) if residual_hi is not None
         else residual(u))
    res_ls = residual if residual_hi is None else residual_hi
    M = precond_builder(u)
    delta, linres = _direction(jvp, f, M, config)
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
    if not (math.isfinite(fnew) and fnew < fnorm):
        return u, fnorm, linres, False
    return u + lam * delta, fnew, linres, True


def newton_converged(fnorm: float, f0_norm: float, target: float,
                     stalls: int, config: NewtonConfig,
                     iter_capped: bool = False) -> bool:
    """Final verdict: ||F|| <= target, or — with `accept_reduction` — an
    exit on the stall limit or the iteration cap whose kept-best iterate
    still reduced ||F|| by that factor."""
    return math.isfinite(fnorm) and (
        fnorm <= target
        or _stall_accept(fnorm, f0_norm, stalls, config, iter_capped))


def _stall_accept(fnorm, f0_norm, stalls, config, iter_capped) -> bool:
    return (config.accept_reduction > 0
            and (stalls >= config.max_stalls or iter_capped)
            and fnorm <= config.accept_reduction * f0_norm)


def newton_solve(residual: Callable, jacobian_action: Callable,
                 delta: torch.Tensor, config: NewtonConfig,
                 precond_builder: Callable,
                 residual_hi: Optional[Callable] = None,
                 predicted: bool = False, dyn_atol: float = 0.0):
    """Solve residual(delta) = 0 from `delta`, one host-driven iteration at
    a time. Returns (delta, NewtonInfo).

    `predicted`: `delta` is an extrapolated guess. The rtol target is then
    tied to the unpredicted ||R(0)||, and the solve starts from 0 when the
    guess does not have the smaller residual. `dyn_atol` is a further
    absolute target (the driver's floor_atol)."""
    res0 = residual if residual_hi is None else residual_hi
    f0 = f_guess = float(_norm(res0(delta)))
    if predicted:
        zero = torch.zeros_like(delta)
        f00 = float(_norm(res0(zero)))
        if not math.isfinite(f0) or f0 >= f00:
            delta, f0 = zero, f00
        f0 = min(f0, f00)
        target = max(config.rtol * f00, config.atol)
    else:
        target = max(config.rtol * f0, config.atol)
    target = max(target, dyn_atol)
    # the hot iteration runs without the rescue; a non-improving one is
    # taken again with it
    hot = (dataclasses.replace(config, true_res_rescue=0.0)
           if config.true_res_rescue > 0 else config)
    fnorm, k, linres = f0, 0, math.inf
    stalls = 0 if math.isfinite(f0) else 99
    while (fnorm > target and k < config.max_iter
           and stalls < config.max_stalls and math.isfinite(fnorm)):
        out = newton_iteration(residual, jacobian_action, delta, fnorm, hot,
                               precond_builder, residual_hi)
        if not out[3] and config.true_res_rescue > 0:
            out = newton_iteration(residual, jacobian_action, delta, fnorm,
                                   config, precond_builder, residual_hi)
        delta, fnorm, linres, improved = out
        stalls = 0 if improved else stalls + 1
        k += 1
    capped = k >= config.max_iter
    converged = newton_converged(fnorm, f0, target, stalls, config, capped)
    strict = math.isfinite(fnorm) and fnorm <= target
    # res0_norm is the residual at the guess, as the JAX package reports it
    return delta, NewtonInfo(converged, k, fnorm, f_guess, linres,
                             converged and not strict)
