"""Adaptive solve driver: reject/retry BDF stepping with error control.

The reference's `adaptive_solver` semantics (`fedm/functions.py:954-1130`)
as a bounded host loop around one attempted step:

- attempt: t += dt, Newton solve;
- on success: relative l2 step error on the monitored component;
- error >= ttol: dt *= 0.5*ttol/error, retry; Newton failure: dt *= 0.5,
  retry; dt < dt_min: SystemExit;
- after acceptance: optional `post_accept` projection of the state, then
  dt_old <- dt and dt <- PID controller(dt, error history).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..constants import DOLFIN_EPS
from ..model.system import CoupledSystem, StepParams
from .controllers import adaptive_timestep


def step_error_norm(var_new: torch.Tensor,
                    var_old: torch.Tensor) -> torch.Tensor:
    """Relative l2 step error with the reference's DOLFIN_EPS shift."""
    num = torch.linalg.vector_norm(var_new - var_old + DOLFIN_EPS)
    return num / torch.linalg.vector_norm(var_old + DOLFIN_EPS)


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


class AdaptiveDriver:
    MAX_RETRIES = 60

    def __init__(self, system: CoupledSystem, monitor_idx: int, ttol: float,
                 dt_min: float, dt_max: float, verbose: bool = False,
                 post_accept: Optional[Callable] = None):
        self.system = system
        self.monitor_idx = monitor_idx
        self.ttol = ttol
        self.dt_min = dt_min
        self.dt_max = dt_max
        self.verbose = verbose
        self.post_accept = post_accept

    def advance(self, state: TimeState) -> TimeState:
        """One accepted BDF step, with as many rejected attempts as the
        error control demands; rotates the history first."""
        u_old1, u_old = state.u_old, state.u
        dt, dt_old = state.dt, state.dt_old
        n_rejected = state.n_rejected
        for _ in range(self.MAX_RETRIES):
            t_try = state.t + dt
            params = StepParams(t_try, dt, dt_old)
            u_new, info = self.system.step(u_old, u_old, u_old1, params)
            if self.verbose:
                print(f"t = {t_try:.6e} dt = {dt:.6e}: newton "
                      f"converged={info.converged} iters={info.iters} "
                      f"res {info.res0_norm:.3e} -> {info.res_norm:.3e} "
                      f"linres={info.lin_relres:.2e}", flush=True)
            if info.converged:
                m = self.monitor_idx
                err = float(step_error_norm(u_new[:, m], u_old[:, m]))
                if err < self.ttol:
                    if self.post_accept is not None:
                        u_new = self.post_accept(u_new)
                    max_error = [err, state.max_error[0], state.max_error[1]]
                    new_dt = adaptive_timestep(dt, max_error, self.ttol,
                                               self.dt_min, self.dt_max)
                    return TimeState(u=u_new, u_old=u_old, u_old1=u_old1,
                                     t=t_try, dt=new_dt, dt_old=dt,
                                     max_error=max_error,
                                     n_accepted=state.n_accepted + 1,
                                     n_rejected=n_rejected)
                dt = dt * 0.5 * self.ttol / err
            else:
                dt = dt * 0.5
            n_rejected += 1
            if dt < self.dt_min:
                raise SystemExit("Minimum time-step size reached, program "
                                 "is terminating.")
        raise SystemExit(f"adaptive driver: no accepted step after "
                         f"{self.MAX_RETRIES} retries")
