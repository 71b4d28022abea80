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

import numpy as np
import torch

from .linear import (_norm, _where_b, bicgstab, bicgstab_batched, finite,
                     finite_b, gmres, gmres_batched, norm_b)

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
    # build the block preconditioner once, at the initial iterate, instead
    # of at every iterate (PETSc's -snes_lag_jacobian); the whole-solve
    # loops (`newton_krylov`, `newton_krylov_batched`) honour it, the host
    # loop does not, as in the JAX package
    freeze_precond: bool = False

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


def _direction(jvp: Callable, f: torch.Tensor, M: Callable,
               config: NewtonConfig, group=None):
    """The Krylov solve of J d = -f: (d, linear relative residual)."""
    # left preconditioning: the Krylov tolerance becomes a per-row relative
    # accuracy on the log-form rows of wildly different scale
    def op(v):
        return M(jvp(v))

    rhs = M(-f)
    kw = dict(tol=config.linear_tol, maxiter=config.linear_maxiter,
              stall_window=config.linear_stall_window, group=group)
    if config.linear_solver == "gmres":
        d, linres, _ = gmres(op, rhs, restart=config.gmres_restart, **kw)
        return d, float(linres)
    d, linres, _ = bicgstab(op, rhs, **kw)
    lr = float(linres)
    d_ok = finite(d, group)
    if config.gmres_fallback and (lr > config.linear_tol
                                  or not math.isfinite(lr) or not d_ok):
        # a non-finite direction restarts GMRES from zero
        x0 = d if d_ok else torch.zeros_like(d)
        d, linres, _ = gmres(op, rhs, x0=x0, restart=config.gmres_restart,
                             **kw)
        lr = float(linres)
    if config.true_res_rescue > 0:
        d = _true_res_rescue(jvp, f, M, d, config, group)
    return d, lr


def _true_res_rescue(jvp, f, M, d, config: NewtonConfig,
                     group=None) -> torch.Tensor:
    """Keep `d`, or the right-preconditioned GMRES direction when `d`
    does not reduce the true linear residual by `true_res_rescue` and the
    GMRES one reduces it more."""
    f_n = _norm(f, group)
    lt0 = float(_norm(f + jvp(d), group) / f_n)
    if math.isfinite(lt0) and lt0 <= config.true_res_rescue:
        return d
    y, _, _ = gmres(lambda v: jvp(M(v)), -f, tol=config.linear_tol,
                    maxiter=config.linear_maxiter,
                    restart=config.gmres_restart,
                    stall_window=config.linear_stall_window, group=group)
    d2 = M(y)
    if finite(d2, group):
        lt2 = float(_norm(f + jvp(d2), group) / f_n)
    else:
        d2, lt2 = torch.zeros_like(d2), math.inf
    return d2 if (lt2 < lt0 or not math.isfinite(lt0)) else d


def newton_iteration(residual: Callable, jacobian_action: Callable,
                     u: torch.Tensor, fnorm: float, config: NewtonConfig,
                     precond_builder: Callable,
                     residual_hi: Optional[Callable] = None, group=None):
    """One damped Newton-Krylov iteration at the iterate `u`.

    `jacobian_action(u)` returns the map v -> J(u) v and
    `precond_builder(u)` the preconditioner r -> M^-1 r. `residual_hi`,
    when given, is a float64
    evaluation of the same residual: it supplies the Newton right-hand side
    and every line-search norm (the incoming `fnorm` must come from it too).
    `group` (`parallel.ranks`): `u` is each rank's rows; every norm, and
    so every decision, is the same on every rank.

    Returns (u_new, fnorm_new, linres, improved, step_ok): `u_new` and
    `fnorm_new` keep the incoming iterate when the line search finds no
    reduction; `step_ok` is the stol criterion.
    """
    jvp = jacobian_action(u)
    f = (residual_hi(u).to(u.dtype) if residual_hi is not None
         else residual(u))
    res_ls = residual if residual_hi is None else residual_hi
    M = precond_builder(u)
    delta, linres = _direction(jvp, f, M, config, group)
    if config.delta_clip:
        lim = torch.as_tensor(config.delta_clip, dtype=delta.dtype,
                              device=delta.device)
        delta = torch.clamp(delta, -lim, lim)

    # backtracking line search, the full step probed first
    lam, h = 1.0, 0
    fnew = float(_norm(res_ls(u + delta), group))
    while (not fnew <= (1.0 - config.armijo * lam) * fnorm
           and h < config.max_halvings):
        lam *= 0.5
        fnew = float(_norm(res_ls(u + lam * delta), group))
        h += 1
    # a non-reducing iteration keeps the better iterate (a stall)
    if not (math.isfinite(fnew) and fnew < fnorm):
        return u, fnorm, linres, False, False
    u_new = u + lam * delta
    # stol: an improving full step already below stol * ||iterate||; a
    # damped step's small update means stuck, not converged
    step_ok = (config.stol > 0 and lam >= 1.0
               and float(_norm(delta, group))
               <= config.stol * float(_norm(u_new, group)))
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
                 lazy_rescue: bool = True, group=None):
    """Solve residual(delta) = 0 from `delta`, one host-driven iteration at
    a time. Returns (delta, NewtonInfo).

    `predicted`: `delta` is an extrapolated guess. The rtol target is then
    tied to the unpredicted ||R(0)||, and the solve starts from 0 when the
    guess does not have the smaller residual. `dyn_atol` is a further
    absolute target (the driver's floor_atol). `lazy_rescue`: the
    true-residual rescue runs only on an iteration that did not improve,
    taken again with it; else on every direction. `group`: `delta` is
    each rank's rows (`newton_iteration`)."""
    res0 = residual if residual_hi is None else residual_hi
    f0 = f_guess = float(_norm(res0(delta), group))
    if predicted:
        zero = torch.zeros_like(delta)
        f00 = float(_norm(res0(zero), group))
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
                               precond_builder, residual_hi, group)
        if lazy and not out[3]:
            out = newton_iteration(residual, jacobian_action, delta, fnorm,
                                   config, precond_builder, residual_hi,
                                   group)
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
                  residual_hi: Optional[Callable] = None, group=None):
    """The JAX package's whole-solve loop: the target is max(rtol *
    ||R(delta)||, atol), with no predictor anchoring and no dynamic
    target, and the configured rescue checks every direction; with
    `freeze_precond` the preconditioner is built once, at `delta`. Returns
    (delta, NewtonInfo)."""
    return newton_solve(residual, jacobian_action, delta, config,
                        _frozen(precond_builder, delta, config), residual_hi,
                        lazy_rescue=False, group=group)


def _frozen(precond_builder: Callable, delta: torch.Tensor,
            config: NewtonConfig) -> Callable:
    """`precond_builder`, or with `freeze_precond` a builder that returns
    the preconditioner built once, at `delta`."""
    if not config.freeze_precond:
        return precond_builder
    M = precond_builder(delta)
    return lambda _u: M


# -- batched: B independent solves on a leading member axis ------------------


def _direction_batched(jvp: Callable, f: torch.Tensor, M: Callable,
                       config: NewtonConfig, run: np.ndarray):
    """`_direction` of each member in `run`: (d [B, ...], linear relative
    residuals [B] numpy). GMRES runs for the members whose BiCGStab
    failed, and the rescue for those whose direction needs it; the other
    members' results stay as they were (what the JAX package's `lax.cond`
    under `vmap`, a select of both branches, gives each member)."""
    def op(v):
        return M(jvp(v))

    rhs = M(-f)
    kw = dict(tol=config.linear_tol, maxiter=config.linear_maxiter,
              stall_window=config.linear_stall_window, active=run)
    if config.linear_solver == "gmres":
        d, linres, _ = gmres_batched(op, rhs, restart=config.gmres_restart,
                                     **kw)
        return d, linres.cpu().numpy()
    d, linres, _ = bicgstab_batched(op, rhs, **kw)
    lr = linres.cpu().numpy()
    d_ok = finite_b(d)
    need = run & ((lr > config.linear_tol) | ~np.isfinite(lr)
                  | ~d_ok.cpu().numpy())
    if config.gmres_fallback and need.any():
        # a non-finite direction restarts GMRES from zero
        x0 = _where_b(d_ok, d, torch.zeros_like(d))
        kw["active"] = need
        d2, lr2, _ = gmres_batched(op, rhs, x0=x0,
                                   restart=config.gmres_restart, **kw)
        d = _where_b(torch.as_tensor(need, device=d.device), d2, d)
        lr = np.where(need, lr2.cpu().numpy(), lr)
    if config.true_res_rescue > 0:
        d = _true_res_rescue_batched(jvp, f, M, d, config, run)
    return d, lr


def _true_res_rescue_batched(jvp, f, M, d, config: NewtonConfig,
                             run: np.ndarray) -> torch.Tensor:
    """`_true_res_rescue` of each member in `run`."""
    f_n = norm_b(f)
    lt0 = (norm_b(f + jvp(d)) / f_n).cpu().numpy()
    need = run & ~(np.isfinite(lt0) & (lt0 <= config.true_res_rescue))
    if not need.any():
        return d
    y, _, _ = gmres_batched(lambda v: jvp(M(v)), -f, tol=config.linear_tol,
                            maxiter=config.linear_maxiter,
                            restart=config.gmres_restart,
                            stall_window=config.linear_stall_window,
                            active=need)
    d2 = M(y)
    d2_ok = finite_b(d2)
    d2 = _where_b(d2_ok, d2, torch.zeros_like(d2))
    lt2 = torch.where(d2_ok, norm_b(f + jvp(d2)) / f_n,
                      torch.inf).cpu().numpy()
    keep2 = need & ((lt2 < lt0) | ~np.isfinite(lt0))
    return _where_b(torch.as_tensor(keep2, device=d.device), d2, d)


def newton_iteration_batched(residual: Callable, jacobian_action: Callable,
                             u: torch.Tensor, fnorm: np.ndarray,
                             config: NewtonConfig, precond_builder: Callable,
                             residual_hi: Optional[Callable] = None,
                             run: Optional[np.ndarray] = None):
    """`newton_iteration` of each member in `run` ([B] bool), each with its
    own line search. Returns (u_new, fnorm_new, linres, improved, step_ok),
    the last four [B] numpy; members outside `run` keep their iterate."""
    B = u.shape[0]
    run = np.ones(B, bool) if run is None else run
    dev = u.device

    def col(a):
        return torch.as_tensor(a, device=dev).reshape(
            (-1,) + (1,) * (u.dim() - 1)).to(u.dtype)

    jvp = jacobian_action(u)
    f = (residual_hi(u).to(u.dtype) if residual_hi is not None
         else residual(u))
    res_ls = residual if residual_hi is None else residual_hi
    M = precond_builder(u)
    delta, linres = _direction_batched(jvp, f, M, config, run)
    if config.delta_clip:
        lim = torch.as_tensor(config.delta_clip, dtype=delta.dtype,
                              device=dev)
        delta = torch.clamp(delta, -lim, lim)

    # per-member backtracking line search, the full step probed first
    lam, h = np.ones(B), np.zeros(B, int)
    fnew = norm_b(res_ls(u + col(lam) * delta)).cpu().numpy()

    def searching():
        return run & ~(fnew <= (1.0 - config.armijo * lam) * fnorm) \
            & (h < config.max_halvings)

    ls = searching()
    while ls.any():
        lam = np.where(ls, lam * 0.5, lam)
        fn = norm_b(res_ls(u + col(lam) * delta)).cpu().numpy()
        fnew = np.where(ls, fn, fnew)
        h = h + ls
        ls = searching()
    improved = run & np.isfinite(fnew) & (fnew < fnorm)
    imp = torch.as_tensor(improved, device=dev)
    u_new = _where_b(imp, u + col(lam) * delta, u)
    fnorm_new = np.where(improved, fnew, fnorm)
    step_ok = np.zeros(B, bool)
    if config.stol > 0:
        small = (norm_b(delta) <= config.stol * norm_b(u_new)).cpu().numpy()
        step_ok = improved & (lam >= 1.0) & small
    return u_new, fnorm_new, linres, improved, step_ok


def newton_krylov_batched(residual: Callable, jacobian_action: Callable,
                          delta: torch.Tensor, config: NewtonConfig,
                          precond_builder: Callable,
                          residual_hi: Optional[Callable] = None,
                          active: Optional[np.ndarray] = None,
                          atol: Optional[np.ndarray] = None):
    """`newton_krylov` of B independent systems on delta [B, ...]: each
    member has its own target, counters and verdict, iterates until it
    stops, and is not touched after. Members outside `active` do not
    iterate. `atol` [B]: each member's absolute target in place of
    `config.atol` (a row-scaled system's is relative to the member's own
    state). Returns (delta, NewtonInfo of [B] numpy arrays)."""
    B = delta.shape[0]
    act = np.ones(B, bool) if active is None else np.asarray(active, bool)
    res0 = residual if residual_hi is None else residual_hi
    f0 = norm_b(res0(delta)).cpu().numpy()
    target = np.maximum(config.rtol * f0,
                        config.atol if atol is None else atol)
    fnorm, linres = f0.copy(), np.full(B, np.inf)
    k = np.zeros(B, int)
    step_ok = np.zeros(B, bool)
    stalls = np.where(np.isfinite(f0), 0, 99)

    def running():
        return (act & (fnorm > target) & (k < config.max_iter)
                & (stalls < config.max_stalls) & np.isfinite(fnorm)
                & ~step_ok)

    precond_builder = _frozen(precond_builder, delta, config)
    run = running()
    while run.any():
        delta, fn, lr, improved, ok = newton_iteration_batched(
            residual, jacobian_action, delta, fnorm, config, precond_builder,
            residual_hi, run)
        fnorm = np.where(run, fn, fnorm)
        linres = np.where(run, lr, linres)
        step_ok = np.where(run, ok, step_ok)
        stalls = np.where(run, np.where(improved, 0, stalls + 1), stalls)
        k = k + run
        run = running()
    capped = k >= config.max_iter
    converged = np.array([newton_converged(
        fnorm[b], f0[b], target[b], stalls[b], config, capped[b],
        step_ok[b]) for b in range(B)])
    strict = np.isfinite(fnorm) & ((fnorm <= target) | step_ok)
    return delta, NewtonInfo(converged, k, fnorm, f0, linres,
                             converged & ~strict)
