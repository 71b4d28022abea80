"""Checkpoint restart: the npz format the JAX package writes (u, u_old,
u_old1, t, dt, dt_old, max_error, n_accepted, n_rejected), read with
numpy."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..convert import state_from_arrays
from ..timestepping.driver import TimeState


def load_checkpoint(path, device="cuda") -> TimeState:
    with np.load(Path(path)) as z:
        return state_from_arrays({k: z[k] for k in z.files}, device=device)
