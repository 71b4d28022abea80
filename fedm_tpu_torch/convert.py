"""State conversion between the JAX package and the port.

In this system the "weights" are the time-stepping state (u, u_old, u_old1,
t, dt, dt_old, max_error and the step counters) and the static geometry.
The geometry is a pure function of the model configuration and is rebuilt
by each package from the same configuration; the state moves between them
as numpy arrays — as `fedm_tpu.io.checkpoint.load_checkpoint` or a JAX
`TimeState` (through `np.asarray`) hands them out. A fixed-dt run such as
the time-of-flight models keeps one field, u [n_dofs, n_eq] (P1 or P2
dofs), which `field_from_array` moves (`.cpu().numpy()` moves it back).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ._device import resolve_device
from .timestepping.driver import TimeState

FIELDS = ("u", "u_old", "u_old1")
SCALARS = ("t", "dt", "dt_old")
COUNTERS = ("n_accepted", "n_rejected")


def field_from_array(u, device="cuda") -> torch.Tensor:
    """One state field, e.g. a time-of-flight run's u [n_dofs, 1], as a
    float64 tensor on `device`."""
    return torch.tensor(np.asarray(u, np.float64),
                        device=resolve_device(device))


def state_from_arrays(src, device="cuda") -> TimeState:
    """Build the port's TimeState (float64 tensors on `device`) from a
    mapping or an object with the JAX TimeState's fields."""
    def get(name):
        return src[name] if isinstance(src, Mapping) else getattr(src, name)

    dev = resolve_device(device)
    return TimeState(
        **{k: torch.tensor(np.asarray(get(k), np.float64), device=dev)
           for k in FIELDS},
        **{k: float(np.asarray(get(k))) for k in SCALARS},
        max_error=[float(e) for e in np.asarray(get("max_error"))],
        **{k: int(np.asarray(get(k))) for k in COUNTERS})


def state_to_arrays(state: TimeState) -> dict:
    """The port's TimeState as numpy arrays and Python scalars under the
    JAX TimeState's field names (the checkpoint's keys)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}
    out.update({k: float(getattr(state, k)) for k in SCALARS})
    out["max_error"] = np.asarray(state.max_error, np.float64)
    out.update({k: int(getattr(state, k)) for k in COUNTERS})
    return out
