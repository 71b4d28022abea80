"""Batched parameter sweeps: B independent simulations of one system on
one device (the JAX package's `parallel/sweep.py`).

The reference's users run a sweep (a seed amplitude, an applied voltage)
as one job per value. Here the B members advance together: each attempt is
one `BatchedSystem.step` over the stacked members, one kernel call and one
scatter launch per operation whatever B is, where the JAX package runs
one `vmap` of `CoupledSystem._step`. Every member marches with its own
adaptive dt: the attempts run in lockstep, acceptance and rejection are
per member on the host, with the reference's shrink rules.

The history rotation is the JAX package's, line for line: an attempt
solves from (u, u_old1) and an accepted member rotates u_old <- u,
u_old1 <- u_old, so from the third attempt on the BDF2 history of a
member is not that of the single-simulation driver (which solves from
(u, u_old)). The port keeps it, so the two packages' sweeps follow the
same trajectories.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..model.system import BatchedSystem, CoupledSystem, StepParams
from ..timestepping.controllers import adaptive_timestep
from ..timestepping.driver import step_error_norm
from .dd import _one_device


@dataclass
class SweepState:
    u: torch.Tensor          # [B, n_dofs, n_eq] float64
    u_old: torch.Tensor
    u_old1: torch.Tensor
    t: np.ndarray            # [B]
    dt: np.ndarray
    dt_old: np.ndarray
    max_error: np.ndarray    # [B, 3]
    n_accepted: np.ndarray = None
    n_rejected: np.ndarray = None

    def __post_init__(self):
        B = len(self.t)
        if self.n_accepted is None:
            self.n_accepted = np.zeros(B, dtype=int)
        if self.n_rejected is None:
            self.n_rejected = np.zeros(B, dtype=int)


class BatchedSweep:
    """Batched adaptive stepping of one CoupledSystem over B independent
    initial conditions (each TimeState a member).

    `batch_sharding`: where the batch lives, a device or a sequence of
    devices (the counterpart of the JAX package's NamedSharding over the
    batch axis). One device (repeated or not) places the states there; it
    must be the system's. Distinct devices raise NotImplementedError, as
    `distribute` does: a batch over several cards is not ported yet."""

    def __init__(self, system: CoupledSystem, monitor_idx: int, ttol: float,
                 dt_min: float, dt_max: float, controller=adaptive_timestep,
                 batch_sharding=None):
        self.system = system
        self.monitor_idx = monitor_idx
        self.ttol = ttol
        self.dt_min = dt_min
        self.dt_max = dt_max
        self.controller = controller
        self.device = None
        if batch_sharding is not None:
            devs = (list(batch_sharding)
                    if isinstance(batch_sharding, (list, tuple))
                    else [batch_sharding])
            self.device = _one_device(devs)
            held = system.bcs.mask.device
            if self.device != held:
                raise ValueError(f"the system lives on {held}; the batch "
                                 f"cannot be placed on {self.device}")
        self.batch_sharding = batch_sharding
        self._batched: Dict[int, BatchedSystem] = {}

    def batched(self, n_members: int) -> BatchedSystem:
        """The stacked system of `n_members` members (built once per B)."""
        if n_members not in self._batched:
            self._batched[n_members] = BatchedSystem(self.system, n_members)
        return self._batched[n_members]

    def _verr(self, u_new: torch.Tensor, u: torch.Tensor) -> np.ndarray:
        i = self.monitor_idx
        return step_error_norm(u_new[:, :, i], u[:, :, i],
                               dim=1).cpu().numpy()

    def from_states(self, states: List) -> SweepState:
        """Stack single-simulation TimeStates into a SweepState."""
        def stack(xs):
            u = torch.stack(xs)
            return u if self.device is None else u.to(self.device)

        return SweepState(
            u=stack([s.u for s in states]),
            u_old=stack([s.u_old for s in states]),
            u_old1=stack([s.u_old1 for s in states]),
            t=np.array([s.t for s in states]),
            dt=np.array([s.dt for s in states]),
            dt_old=np.array([s.dt_old for s in states]),
            max_error=np.array([s.max_error for s in states]),
        )

    def attempt(self, st: SweepState, aux: Dict,
                active: np.ndarray = None) -> SweepState:
        """One lockstep attempted step for every simulation; per-simulation
        accept/reject with the reference's shrink rules.

        `active`: optional [B] bool — simulations marked inactive (already
        past their horizon) are frozen: their state, t, dt and counters do
        not change and they cannot raise a dt_min death. They do not
        iterate in the batched Newton loop, and whatever the step returns
        for them is discarded.
        """
        B = len(st.t)
        if active is None:
            active = np.ones(B, dtype=bool)
        t_try = st.t + st.dt
        params = StepParams(t_try, st.dt, st.dt_old)
        u_new, info = self.batched(B).step(st.u, st.u, st.u_old1, aux,
                                           params, active=active)
        conv = np.asarray(info.converged)
        errs = self._verr(u_new, st.u)

        accept = conv & (errs < self.ttol) & active
        # device-side select of accepted members
        acc_dev = torch.as_tensor(accept, device=st.u.device)[:, None, None]
        u_next = torch.where(acc_dev, u_new, st.u)
        u_old_next = torch.where(acc_dev, st.u, st.u_old)
        u_old1_next = torch.where(acc_dev, st.u_old, st.u_old1)

        t = np.where(accept, t_try, st.t)
        dt = st.dt.copy()
        dt_old = st.dt_old.copy()
        max_error = st.max_error.copy()
        n_accepted = st.n_accepted.copy()
        n_rejected = st.n_rejected.copy()
        for b in range(B):
            if not active[b]:
                continue
            if accept[b]:
                max_error[b] = [errs[b], st.max_error[b, 0],
                                st.max_error[b, 1]]
                dt_old[b] = st.dt[b]
                dt[b] = self.controller(st.dt[b], max_error[b], self.ttol,
                                        self.dt_min, self.dt_max,
                                        dt_old=st.dt_old[b])
                n_accepted[b] += 1
            else:
                dt[b] = (st.dt[b] * 0.5 * self.ttol / errs[b]
                         if conv[b] else st.dt[b] * 0.5)
                n_rejected[b] += 1
                if dt[b] < self.dt_min:
                    raise SystemExit(
                        "Minimum time-step size reached, program is "
                        f"terminating (simulation {b}).")
        return SweepState(u=u_next, u_old=u_old_next, u_old1=u_old1_next,
                          t=t, dt=dt, dt_old=dt_old, max_error=max_error,
                          n_accepted=n_accepted, n_rejected=n_rejected)

    def run_until(self, st: SweepState, T_final: float, aux: Dict,
                  max_attempts: int = 100000) -> SweepState:
        """Advance every simulation to T_final. Finished simulations are
        frozen (not stepped past the horizon, cannot kill the sweep via
        dt_min); each active one has its dt clamped to land on T_final."""
        k = 0
        while (st.t < T_final * (1 - 1e-12)).any() and k < max_attempts:
            active = st.t < T_final * (1 - 1e-12)
            st.dt = np.where(active, np.minimum(st.dt, T_final - st.t),
                             st.dt)
            st = self.attempt(st, aux, active=active)
            k += 1
        return st
