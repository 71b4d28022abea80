"""Checkpoints in the JAX package's npz format (u, u_old, u_old1, t, dt,
dt_old, max_error, n_accepted, n_rejected, plus optional `meta_*`
entries), so each package reads the other's files.

Writes are atomic: the file is written under `<name>.tmp` and renamed into
place, so a kill mid-write never leaves a truncated checkpoint, and the
meta (e.g. the moving window's corridor the state lives on) travels inside
the same file as the state it describes.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from ..convert import state_from_arrays, state_to_arrays
from ..timestepping.driver import TimeState

_META_PREFIX = "meta_"


def save_checkpoint(path, state: TimeState, meta: dict = None) -> None:
    """`meta`: optional {name: scalar or array} entries stored beside the
    state (e.g. {'z_corridor': (z0, z1, dz)} for moving-window runs)."""
    path = Path(path)
    extra = {_META_PREFIX + k: np.asarray(v) for k, v in (meta or {}).items()}
    tmp = path.with_name(path.name + ".tmp")
    # a file object keeps np.savez from appending .npz to the name
    with open(tmp, "wb") as f:
        np.savez(f, **state_to_arrays(state), **extra)
    os.replace(tmp, path)


def load_checkpoint(path, device="cuda", with_meta: bool = False):
    """The TimeState on `device`, or (TimeState, meta) with
    `with_meta=True` (meta is {} for a checkpoint written without it;
    each value comes back as a numpy array)."""
    with np.load(Path(path)) as z:
        state = state_from_arrays({k: z[k] for k in z.files}, device=device)
        if not with_meta:
            return state
        meta = {k[len(_META_PREFIX):]: np.asarray(z[k])
                for k in z.files if k.startswith(_META_PREFIX)}
    return state, meta
