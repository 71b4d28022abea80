"""Adaptive time-step-size controllers (host-side scalar functions), the
reference's three (`fedm/functions.py:915-951`) as the JAX package has them.

`error` = [e0, e1, e2], the errors at the current and the two previous
accepted steps. Every controller takes
``(dt, error, tol, dt_min, dt_max, dt_old=None)``; only H211b reads
`dt_old`, and takes a unit ratio when it is the first-step sentinel 1e30 or
missing.
"""

from __future__ import annotations


def adaptive_timestep(dt, error, tol=1e-4, dt_min=1e-13, dt_max=1e-9,
                      dt_old=None):
    """PID controller (M. Moeller, TU Delft 2015 course notes; reference
    `fedm/functions.py:915-927`)."""
    dt *= ((error[1] / error[0]) ** 0.075
           * (tol / error[0]) ** 0.175
           * (error[1] ** 2 / (error[0] * error[2])) ** 0.01)
    return max(min(dt, dt_max), dt_min)


def adaptive_timestep_PI34(dt, error, tol=1e-4, dt_min=1e-13, dt_max=1e-9,
                           dt_old=None):
    """PI.3.4 controller (G. Soederlind, Numer. Algorithms 31:281, 2002;
    reference `fedm/functions.py:930-937`)."""
    dt *= ((0.8 * tol / error[0]) ** (0.3 / 3)
           * (0.8 * error[1] / error[0]) ** (0.4 / 3))
    return max(min(dt, dt_max), dt_min)


def adaptive_timestep_H211b(dt, error, tol=1e-4, dt_min=1e-13, dt_max=1e-9,
                            dt_old=None):
    """H211b controller (G. Soederlind, ACM TOMS 29:1, 2003; reference
    `fedm/functions.py:940-951`)."""
    if dt_old is None or not 0.0 < dt_old < 1e29:
        dt_old = dt
    dt *= ((0.8 * tol / error[0]) ** (1 / 12)
           * (0.8 * tol / error[1]) ** (1 / 12)
           * (dt / dt_old) ** (-1 / 4))
    return max(min(dt, dt_max), dt_min)
