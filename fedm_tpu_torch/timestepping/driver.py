"""Adaptive solve driver: reject/retry BDF stepping with error control.

The reference's `adaptive_solver` semantics (`fedm/functions.py:954-1130`)
as a bounded host loop around one attempted step, with the JAX package's
options (`timestepping/driver.py`):

- attempt: t += dt, Newton solve from u_old, or from the BDF extrapolation
  u_old + p*(dt/dt_old)*(u_old - u_old1) with `predictor` = p when the
  solving system runs the host loop (`NewtonConfig.host_loop`, not
  row-scaled);
- on success: relative l2 step error on the monitored component(s),
  appended to `relative error.log` in the reference's column format;
- error >= ttol: dt *= 0.5*ttol/error, retry; Newton failure: dt *= 0.5,
  retry; dt < dt_min: SystemExit, after saving the last good state to
  `crash_checkpoint` when one is set;
- precision escalation: with a `fallback_system`, a failed attempt retries
  the same dt there, and after `escalate_after_rejects` rejections within
  one advance every further attempt of it runs there;
- `fail_dt_cap`: a Newton failure at dt_f caps later proposals at
  fail_dt_cap*dt_f, relaxed by `fail_cap_recovery` per acceptance;
- `floor_atol` = C: the solve gets the absolute target C*floor, the floor
  being the final ||F|| of the last genuinely solved step;
- after acceptance: optional `post_accept` projection of the state, then
  dt_old <- dt and dt <- controller(dt, error history).

Two behaviours are the reference's and kept as they are, so that the two
packages follow the same trajectory: the failure-triggered escalation
steps the fallback without refreshing its `dyn_atol`, and a failed solve
that halved ||F|| re-anchors the floor however far above the old floor
its final ||F|| lies.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from ..constants import DOLFIN_EPS
from ..model.system import CoupledSystem, StepParams
from ..solvers.linear import combine_norms
from .controllers import adaptive_timestep


def step_error_norm(var_new: torch.Tensor, var_old: torch.Tensor,
                    dim=None, group=None) -> torch.Tensor:
    """Relative l2 step error with the reference's DOLFIN_EPS shift; with
    `dim`, one per member of a batch (the norms reduce over `dim` only).
    Over a `group` (`parallel.ranks`) the vectors are each rank's rows and
    both norms are combined over the ranks (one all-reduce)."""
    num = torch.linalg.vector_norm(var_new - var_old + DOLFIN_EPS, dim=dim)
    den = torch.linalg.vector_norm(var_old + DOLFIN_EPS, dim=dim)
    num, den = combine_norms(torch.stack([num, den]), group).unbind()
    return num / den


@dataclass
class TimeState:
    """Everything needed to advance and to checkpoint: the float64 states
    [n_dofs, n_eq] and the controller's scalars."""

    u: torch.Tensor
    u_old: torch.Tensor
    u_old1: torch.Tensor
    t: float = 0.0
    dt: float = 1e-13
    dt_old: float = 1e30
    max_error: list = field(default_factory=lambda: [1.0, 1.0, 1.0])
    n_accepted: int = 0
    n_rejected: int = 0


def restart_bdf_history(state: TimeState,
                        dt: Optional[float] = None) -> TimeState:
    """Restart the multistep history in place: the next attempt is a
    backward-Euler step from `state.u` (u_old = u_old1 = u, dt_old = the
    first-step sentinel 1e30), optionally at a new `dt`. A state remapped
    across resolutions needs it: its u_old and u_old1 were remapped
    separately, so their difference no longer approximates a time
    derivative on the new mesh."""
    state.u_old = state.u
    state.u_old1 = state.u
    state.dt_old = 1e30
    if dt is not None:
        state.dt = dt
    return state


def _info_line(info) -> str:
    return (f"converged={bool(info.converged)} iters={int(info.iters)} "
            f"res {float(info.res0_norm):.3e} -> {float(info.res_norm):.3e} "
            f"linres={float(info.lin_relres):.2e}")


class AdaptiveDriver:
    def __init__(self, system: CoupledSystem, monitor_idx, ttol: float,
                 dt_min: float, dt_max: float,
                 controller: Callable = adaptive_timestep,
                 error_log: Optional[Path] = None, max_retries: int = 60,
                 verbose: bool = False,
                 fallback_system: Optional[CoupledSystem] = None,
                 escalate_after_rejects: int = 2,
                 crash_checkpoint: Optional[Path] = None,
                 crash_meta: Optional[Callable] = None,
                 post_accept: Optional[Callable] = None,
                 fail_dt_cap: float = 0.0, fail_cap_recovery: float = 1.05,
                 predictor: float = 0.0, newton_log: Optional[Path] = None,
                 floor_atol: float = 0.0):
        self.system = system
        # an int (the reference's monitor) or a tuple/list (max over them)
        self.monitor_idx = monitor_idx
        self.ttol = ttol
        self.dt_min = dt_min
        self.dt_max = dt_max
        self.controller = controller
        self.error_log = Path(error_log) if error_log is not None else None
        self.max_retries = max_retries
        self.verbose = verbose
        self.fallback_system = fallback_system
        self.escalate_after_rejects = escalate_after_rejects
        self.n_escalated = 0
        # accepted steps whose Newton exit was the accept_reduction clause
        self.n_stall_accepted = 0
        self.newton_log = Path(newton_log) if newton_log is not None else None
        self.floor_atol = floor_atol
        self._res_floor = float("inf")
        self.crash_checkpoint = (Path(crash_checkpoint)
                                 if crash_checkpoint is not None else None)
        # a callable, not a dict: window moves change the geometry mid-run
        self.crash_meta = crash_meta
        self.post_accept = post_accept
        self.fail_dt_cap = fail_dt_cap
        self.fail_cap_recovery = fail_cap_recovery
        self._dt_cap = float("inf")
        self.predictor = predictor

    def _die(self, state: TimeState, n_rejected: int, msg: str):
        # a system on z-slabs holds its rank's rows: every rank gathers the
        # whole state (a collective), the rank given a crash checkpoint
        # writes it
        whole = getattr(self.system, "gather_state", None)
        if whole is not None and getattr(self.system, "slabs", None):
            state = TimeState(u=whole(state.u), u_old=whole(state.u_old),
                              u_old1=whole(state.u_old1), t=state.t,
                              dt=state.dt, dt_old=state.dt_old,
                              max_error=state.max_error,
                              n_accepted=state.n_accepted)
        if self.crash_checkpoint is not None:
            from ..io.checkpoint import save_checkpoint

            last_good = TimeState(
                u=state.u, u_old=state.u_old, u_old1=state.u_old1,
                t=state.t, dt=state.dt, dt_old=state.dt_old,
                max_error=list(state.max_error),
                n_accepted=state.n_accepted, n_rejected=n_rejected)
            save_checkpoint(self.crash_checkpoint, last_good,
                            meta=self.crash_meta() if self.crash_meta
                            else None)
            msg += f" Last good state saved to {self.crash_checkpoint}."
        raise SystemExit(msg)

    def _monitor_error(self, u_new, u_old) -> float:
        # a distributed system's rows are its rank's: the norms are summed
        # over its group, so every rank takes the same decisions
        group = getattr(self.system, "group", None)
        idx = self.monitor_idx
        if isinstance(idx, int):
            return float(step_error_norm(u_new[:, idx], u_old[:, idx],
                                         group=group))
        return max(float(step_error_norm(u_new[:, i], u_old[:, i],
                                         group=group)) for i in idx)

    def _log_error(self, err: float, dt_old: float, dt: float) -> None:
        if self.error_log is None:
            return
        with open(self.error_log, "a") as f:
            f.write(f"{err:<23}  {dt_old:<23}  {dt:<23}\n")

    def advance(self, state: TimeState,
                aux: Optional[Dict] = None) -> TimeState:
        """One accepted BDF step, with as many rejected attempts as the
        error control demands; rotates the history first. `aux`: the
        step's auxiliary fields, handed to every attempt's kernels (the
        glow's coefficients at the last accepted state); None is {}."""
        aux = {} if aux is None else aux
        u_old1, u_old = state.u_old, state.u
        dt, dt_old = state.dt, state.dt_old
        n_rejected = state.n_rejected
        rejects_here = 0
        for _ in range(self.max_retries):
            t_try = state.t + dt
            params = StepParams(t_try, dt, dt_old)
            if self.verbose:
                print(f"Attempting to solve the equation for t = {t_try} "
                      f"with dt = {dt}", flush=True)
            escalated = (self.fallback_system is not None
                         and rejects_here >= self.escalate_after_rejects)
            solve_sys = self.fallback_system if escalated else self.system
            if escalated:
                self.n_escalated += 1
                if self.verbose:
                    print(f"Escalating precision for t = {t_try} "
                          f"(rejection-rate trigger)", flush=True)
            # predict only into a host-loop solve: `newton_solve`
            # re-anchors its rtol target for a supplied guess, the
            # whole-solve loop does not and starts from u_old
            newton = getattr(solve_sys, "newton", None)
            pred_ok = (getattr(newton, "host_loop", False)
                       and not getattr(solve_sys, "row_scaled", False))
            if self.predictor > 0.0 and pred_ok and 0.0 < dt_old < 1e29:
                # a new tensor: the system detects a supplied guess by
                # identity and anchors its rtol target to ||R(0)||
                ratio = min(dt / dt_old, 2.0)
                u_guess = u_old + (self.predictor * ratio) * (u_old - u_old1)
            else:
                u_guess = u_old
            if self.floor_atol > 0.0:
                solve_sys.dyn_atol = (self.floor_atol * self._res_floor
                                      if self._res_floor < float("inf")
                                      else 0.0)
            t0 = time.perf_counter()
            u_new, info = solve_sys.step(u_guess, u_old, u_old1, aux, params)
            if self.verbose:
                print(f"  newton: {_info_line(info)} "
                      f"[{time.perf_counter() - t0:.1f}s]", flush=True)
            if (not info.converged and not escalated
                    and self.fallback_system is not None):
                if self.verbose:
                    print(f"Escalating precision for t = {t_try}",
                          flush=True)
                u_new, info = self.fallback_system.step(u_old, u_old, u_old1,
                                                        aux, params)
                self.n_escalated += 1
                if self.verbose:
                    print(f"  newton(f64): {_info_line(info)}", flush=True)
            if info.converged:
                err = self._monitor_error(u_new, u_old)
                if self.verbose:
                    print(f"  step error = {err:.3e} (ttol {self.ttol:g})",
                          flush=True)
                self._log_error(err, dt_old, dt)
                if err < self.ttol:
                    return self._accept(state, info, u_new, u_old, u_old1,
                                        err, t_try, dt, dt_old, n_rejected)
                dt = dt * 0.5 * self.ttol / err
            else:
                if self.floor_atol > 0.0:
                    # a failed solve that halved ||F|| measured the floor
                    rn, r0 = info.res_norm, info.res0_norm
                    if rn == rn and rn > 0 and info.iters > 0 \
                            and rn <= 0.5 * r0:
                        self._res_floor = rn
                if self.fail_dt_cap > 0.0:
                    self._dt_cap = min(self._dt_cap, self.fail_dt_cap * dt)
                dt = dt * 0.5
            n_rejected += 1
            rejects_here += 1
            if dt < self.dt_min:
                self._die(state, n_rejected, "Minimum time-step size "
                          "reached, program is terminating.")
        self._die(state, n_rejected, f"adaptive driver: no accepted step "
                  f"after {self.max_retries} retries")

    def _accept(self, state, info, u_new, u_old, u_old1, err, t_try, dt,
                dt_old, n_rejected) -> TimeState:
        atol_exit = info.iters == 0
        if self.floor_atol > 0.0 and not atol_exit:
            # only a genuine reduction updates the floor: an atol exit has
            # res_norm == res0 and would ratchet it up by C every step
            rn = info.res_norm
            if rn > 0 and rn == rn and rn < info.res0_norm:
                self._res_floor = rn
        if info.stall_accepted:
            self.n_stall_accepted += 1
        if self.newton_log is not None:
            with open(self.newton_log, "a") as f:
                f.write(f"{state.n_accepted + 1} "
                        f"{'stall' if info.stall_accepted else 'conv'} "
                        f"{info.iters} {info.res0_norm:.6e} "
                        f"{info.res_norm:.6e} {dt:.6e}\n")
        if self.post_accept is not None:
            u_new = self.post_accept(u_new)
        max_error = [err, state.max_error[0], state.max_error[1]]
        new_dt = self.controller(dt, max_error, self.ttol, self.dt_min,
                                 self.dt_max, dt_old=dt_old)
        if self.floor_atol > 0.0 and atol_exit:
            # an extrapolation-only step says nothing about a larger dt
            new_dt = min(new_dt, dt)
        if self.fail_dt_cap > 0.0 and self._dt_cap < float("inf"):
            new_dt = min(new_dt, self._dt_cap)
            self._dt_cap *= self.fail_cap_recovery
            if self._dt_cap >= self.dt_max:
                self._dt_cap = float("inf")
        return TimeState(u=u_new, u_old=u_old, u_old1=u_old1, t=t_try,
                         dt=new_dt, dt_old=dt, max_error=max_error,
                         n_accepted=state.n_accepted + 1,
                         n_rejected=n_rejected)
