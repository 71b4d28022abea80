"""Adaptive time-step-size controller (host-side scalar function)."""

from __future__ import annotations


def adaptive_timestep(dt, error, tol=1e-4, dt_min=1e-13, dt_max=1e-9):
    """PID controller (M. Moeller, TU Delft 2015 course notes; reference
    `fedm/functions.py:915-927`). `error` = [e0, e1, e2], the errors at the
    current and the two previous accepted steps."""
    dt *= ((error[1] / error[0]) ** 0.075
           * (tol / error[0]) ** 0.175
           * (error[1] ** 2 / (error[0] * error[2])) ** 0.01)
    return max(min(dt, dt_max), dt_min)
