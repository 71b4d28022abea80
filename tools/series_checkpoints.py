"""Seeded run directories for the post-processing entry points
(`python -m fedm_tpu_torch.export_series`, `.glow_report`) and the JAX
package's `tools/export_series.py` / `tools/glow_report.py`, built with
numpy alone, so that `chip_smoke.py` (no JAX), the CPU tests and
`tools/port_reference_series.py` (JAX) write the same files.

The states are random draws in each column's range (log-densities, volts)
from `np.random.default_rng(seed)`, in the checkpoint format both packages
read (`u`, `u_old`, `u_old1`, `t`, `dt`, `dt_old`, `max_error`,
`n_accepted`, `n_rejected`, `meta_*`).

The streamer trail (`streamer_trail`) has two window corridors in its
meta: two checkpoints on the first (the second reuses the first's mesh),
one on the second (a new mesh), one on the second whose state has fewer
rows than that mesh (skipped), and `checkpoint.npz` repeating the third
(dropped as a duplicate (t, n_accepted)). The glow run (`glow_run`) has
two checkpoints, the later one `checkpoint.npz`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# the bagheri14 protocol's window (python -m fedm_tpu_torch.bagheri_run
# --preset bagheri14: dz 1e-5 over 1.5e-3, tails 10 and 48 cells), and the
# window moved by 0.3 mm
STREAMER_WINDOW = dict(corridors=((1e-4, 1.6e-3, 1e-5),
                                  (4e-4, 1.9e-3, 1e-5)),
                       tails=(10, 48), n_dofs=30305)
# a small window for the CPU tests
STREAMER_SMALL = dict(corridors=((1e-4, 4e-4, 2e-5), (2e-4, 5e-4, 2e-5)),
                      tails=(4, 8), n_dofs=4785)
# the glow50 protocol's crossed 64 x 64 mesh, and a small one
GLOW50 = dict(nx=64, ny=64, n_dofs=8321)
GLOW_SMALL = dict(nx=8, ny=8, n_dofs=145)


def _save(path: Path, u: np.ndarray, t: float, n_accepted: int,
          meta: dict = None) -> None:
    extra = {"meta_" + k: np.asarray(v) for k, v in (meta or {}).items()}
    with open(path, "wb") as f:
        np.savez(f, u=u, u_old=u, u_old1=u, t=t, dt=t / 100.0,
                 dt_old=t / 100.0, max_error=np.array([1e-3, 1e-3, 1e-3]),
                 n_accepted=n_accepted, n_rejected=0, **extra)


def _draw(rng, n: int, ranges) -> np.ndarray:
    """[n, len(ranges)]: column k uniform in ranges[k]."""
    lo, hi = np.array(ranges, np.float64).T
    return lo + (hi - lo) * rng.random((n, len(ranges)))


def streamer_trail(run: Path, corridors, tails, n_dofs: int,
                   seed: int = 0) -> None:
    """The streamer checkpoint trail described in the module docstring
    under `run`: ln n_ion, ln n_e in [ln 1e13, ln 1e20], phi in [0, 18 kV]."""
    run.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    ranges = [(np.log(1e13), np.log(1e20))] * 2 + [(0.0, 1.8e4)]
    protocol = json.dumps({"preset": "bagheri14"})
    for i, (c, rows) in enumerate([(0, n_dofs), (0, n_dofs), (1, n_dofs),
                                   (1, n_dofs - 97)]):
        meta = {"protocol": protocol, "z_corridor": corridors[c],
                "z_tail_cells": tails}
        _save(run / f"checkpoint_{i:06d}.npz", _draw(rng, rows, ranges),
              (i + 1) * 1e-10, 10 * (i + 1), meta)
    (run / "checkpoint.npz").write_bytes(
        (run / "checkpoint_000002.npz").read_bytes())


def glow_run(run: Path, n_dofs: int, seed: int = 0) -> None:
    """Two glow checkpoints under `run` (the LMEA layout: ln w_e, ln Ar*,
    ln Ar+, ln n_e, phi in [-250, 0] V)."""
    run.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    ranges = [(np.log(1e14), np.log(1e17))] * 4 + [(-250.0, 0.0)]
    _save(run / "checkpoint_000000.npz", _draw(rng, n_dofs, ranges), 1e-7,
          100)
    _save(run / "checkpoint.npz", _draw(rng, n_dofs, ranges), 2e-7, 200)
