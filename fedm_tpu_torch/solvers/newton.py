"""Damped Newton-Krylov, one iteration at a time from the host.

Port of the JAX package's `solvers/newton.py`. Its two drive modes share
one iteration body (`newton_iteration`):

- `newton_solve`, the host loop (`NewtonConfig.host_loop`, the JAX
  package's `CoupledSystem._step_host`): a predicted guess re-anchors the
  rtol target to ||R(0)||, the driver's `dyn_atol` is a further target,
  and the true-residual rescue runs only on an iteration that did not
  improve;
- `newton_krylov`, the whole-solve loop (the JAX package's
  `lax.while_loop`): the target is rtol of the residual at the given
  start, and the rescue, when configured, checks every direction.

The Jacobian action is supplied by the caller (forward-mode AD of the
element kernels, see `model.system`); the inner solve is left-
preconditioned BiCGStab with a GMRES(m) fallback and the optional
true-residual rescue, or GMRES(m); the line search is the eager
backtracking structure (full step probed first); the verdict is
SNES-style (rtol/atol, stol) with the noise-floor stall acceptance.
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
    """The JAX package's NewtonConfig fields that the port reads, with the
    same defaults. `host_loop` picks the drive mode (`CoupledSystem.step`):
    both run on the host, PyTorch being eager, but they differ in their
    targets and rescue (module docstring)."""

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
    # SNES-style step tolerance: an improving full step (lam = 1) whose
    # update is below stol * ||iterate|| converges; 0 disables
    stol: float = 0.0
    # accept a stalled (or iteration-capped) solve that reduced ||F|| by at
    # least this factor; 0 disables
    accept_reduction: float = 0.0
    # float64 residual (Newton defect, line-search and convergence norms)
    # with the float32 Jacobian action and Krylov correction
    hi_residual: bool = False
    # the host loop (`newton_solve`) rather than the whole-solve loop
    # (`newton_krylov`); the driver predicts a guess only into the former
    host_loop: bool = False

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

    Returns (u_new, fnorm_new, linres, improved, step_ok): `u_new` and
    `fnorm_new` keep the incoming iterate when the line search finds no
    reduction; `step_ok` is the stol criterion.
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
        return u, fnorm, linres, False, False
    u_new = u + lam * delta
    # stol: an improving full step already below stol * ||iterate||; a
    # damped step's small update means stuck, not converged
    step_ok = (config.stol > 0 and lam >= 1.0
               and float(_norm(delta)) <= config.stol * float(_norm(u_new)))
    return u_new, fnew, linres, True, step_ok


def newton_converged(fnorm: float, f0_norm: float, target: float,
                     stalls: int, config: NewtonConfig,
                     iter_capped: bool = False,
                     step_ok: bool = False) -> bool:
    """Final verdict: ||F|| <= target or the stol criterion, or — with
    `accept_reduction` — an exit on the stall limit or the iteration cap
    whose kept-best iterate still reduced ||F|| by that factor."""
    return math.isfinite(fnorm) and (
        fnorm <= target or step_ok
        or _stall_accept(fnorm, f0_norm, stalls, config, iter_capped))


def _stall_accept(fnorm, f0_norm, stalls, config, iter_capped) -> bool:
    return (config.accept_reduction > 0
            and (stalls >= config.max_stalls or iter_capped)
            and fnorm <= config.accept_reduction * f0_norm)


def newton_solve(residual: Callable, jacobian_action: Callable,
                 delta: torch.Tensor, config: NewtonConfig,
                 precond_builder: Callable,
                 residual_hi: Optional[Callable] = None,
                 predicted: bool = False, dyn_atol: float = 0.0,
                 lazy_rescue: bool = True):
    """Solve residual(delta) = 0 from `delta`, one host-driven iteration at
    a time. Returns (delta, NewtonInfo).

    `predicted`: `delta` is an extrapolated guess. The rtol target is then
    tied to the unpredicted ||R(0)||, and the solve starts from 0 when the
    guess does not have the smaller residual. `dyn_atol` is a further
    absolute target (the driver's floor_atol). `lazy_rescue`: the
    true-residual rescue runs only on an iteration that did not improve,
    taken again with it; else on every direction."""
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
    lazy = lazy_rescue and config.true_res_rescue > 0
    hot = dataclasses.replace(config, true_res_rescue=0.0) if lazy else config
    fnorm, k, linres, step_ok = f0, 0, math.inf, False
    stalls = 0 if math.isfinite(f0) else 99
    while (fnorm > target and k < config.max_iter
           and stalls < config.max_stalls and math.isfinite(fnorm)
           and not step_ok):
        out = newton_iteration(residual, jacobian_action, delta, fnorm, hot,
                               precond_builder, residual_hi)
        if lazy and not out[3]:
            out = newton_iteration(residual, jacobian_action, delta, fnorm,
                                   config, precond_builder, residual_hi)
        delta, fnorm, linres, improved, step_ok = out
        stalls = 0 if improved else stalls + 1
        k += 1
    capped = k >= config.max_iter
    converged = newton_converged(fnorm, f0, target, stalls, config, capped,
                                 step_ok)
    strict = math.isfinite(fnorm) and (fnorm <= target or step_ok)
    # res0_norm is the residual at the guess, as the JAX package reports it
    return delta, NewtonInfo(converged, k, fnorm, f_guess, linres,
                             converged and not strict)


def newton_krylov(residual: Callable, jacobian_action: Callable,
                  delta: torch.Tensor, config: NewtonConfig,
                  precond_builder: Callable,
                  residual_hi: Optional[Callable] = None):
    """The JAX package's whole-solve loop: the target is max(rtol *
    ||R(delta)||, atol), with no predictor anchoring and no dynamic
    target, and the configured rescue checks every direction. Returns
    (delta, NewtonInfo)."""
    return newton_solve(residual, jacobian_action, delta, config,
                        precond_builder, residual_hi, lazy_rescue=False)
