"""The physics report of a glow-discharge checkpoint (the port of the JAX
package's `tools/glow_report.py`: the same analysis, JSON and markdown).

Reads a `python -m fedm_tpu_torch.glow_run` (or `tools/glow_run.py`)
checkpoint and evaluates the discharge structure the reference's flagship
case is known for (`examples/glow_discharge/fedm-gd.py`: 1 Torr argon,
U_w = -250 V, a 1 cm gap, a low-pressure DC glow):

- **cathode fall**: most of the applied voltage drops in a thin sheath at
  the powered (negative) electrode;
- **quasineutral bulk**: |n_i - n_e| / n_e small over the central region;
- **fields finite**.

State layout (`models.glow.GlowDischargeModel`, LMEA): u0 = log
electron-energy density, u1 = log Ar*, u2 = log Ar+, u3 = log n_e,
u4 = phi.

Only the mesh (the node coordinates) is read from the model, and it does
not depend on the transport or rate tables. So the input tree is
`--file-input DIR` where given, else the synthetic argon tree
(`models.argon_synth`) generated into a temporary directory removed at
exit. The analysis runs in numpy on the host.

    python -m fedm_tpu_torch.glow_report RUN_DIR [--nx 64] [--ny 64]
        [--out report.md] [--file-input DIR] [--device cuda]

The model is built on `--device` (default cuda); without a GPU it exits 1
unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ._device import check_device


def profiles(run_dir: Path, nx: int, ny: int, file_input=None,
             device="cuda") -> dict:
    """The mid-column profiles along the gap of the run's checkpoint."""
    from .export_series import glow_model

    d = np.load(run_dir / "checkpoint.npz")
    u = np.asarray(d["u"])
    model = glow_model(nx, ny, file_input, device)
    coords = np.asarray(model.space.dof_coords)
    assert u.shape[0] == coords.shape[0], (
        f"checkpoint dofs {u.shape[0]} != mesh dofs {coords.shape[0]} "
        f"(pass the run's --nx/--ny)")
    # the discharge is ~1D along the gap (axis 1); take the mid-column
    xs = coords[:, 0]
    mid = np.abs(xs - np.median(xs)) < (xs.max() - xs.min()) / (2 * nx)
    z = coords[mid, 1]
    order = np.argsort(z)
    idx = np.where(mid)[0][order]
    return {
        "z": coords[idx, 1],
        "phi": u[idx, 4],
        "ne": np.exp(u[idx, 3]),
        "ni": np.exp(u[idx, 2]),
        "eps": np.exp(u[idx, 0] - u[idx, 3]),
        "t": float(d["t"]),
        "steps": int(d["n_accepted"]),
        "u": u,
    }


def analyze(p: dict) -> dict:
    z, phi, ne, ni = p["z"], p["phi"], p["ne"], p["ni"]
    gap = z.max() - z.min()
    # the cathode is the electrode at the more negative potential
    cath_at_top = phi[-1] < phi[0]
    if cath_at_top:
        phi_c, phi_a = phi[-1], phi[0]
        dist = z.max() - z
    else:
        phi_c, phi_a = phi[0], phi[-1]
        dist = z - z.min()
    fall = phi_a - phi_c  # the whole potential fall toward the cathode
    # the sheath: the distance from the cathode where 90 % of the fall is
    # recovered
    frac = (phi - phi_c) / fall if fall != 0 else np.zeros_like(phi)
    rec = dist[frac >= 0.9]
    sheath = float(rec.min()) if rec.size else float("nan")
    # the quasineutral bulk: the central 50 % of the gap
    bulk = (dist > 0.25 * gap) & (dist < 0.75 * gap)
    qn = np.abs(ni[bulk] - ne[bulk]) / np.maximum(ne[bulk], 1e-30)
    out = {
        "t_s": p["t"],
        "steps": p["steps"],
        "cathode": "z=gap (powered)" if cath_at_top else "z=0",
        "total_fall_V": float(fall),
        "sheath_thickness_mm": sheath * 1e3,
        "sheath_fraction_of_gap": float(sheath / gap),
        "bulk_quasineutrality_median": float(np.median(qn)),
        "bulk_quasineutrality_max": float(qn.max()) if qn.size else None,
        "ne_max_m3": float(ne.max()),
        "ne_bulk_mean_m3": float(ne[bulk].mean()),
        "eps_range_eV": [float(p["eps"].min()), float(p["eps"].max())],
    }
    out["checks"] = {
        # the fall concentrated near the cathode (sheath << gap)
        "cathode_fall_thin": bool(out["sheath_fraction_of_gap"] < 0.35),
        # most of the applied -250 V appears across the fall
        "fall_majority_of_voltage": bool(abs(fall) > 125.0),
        "bulk_quasineutral_trend": bool(
            out["bulk_quasineutrality_median"] < 0.5),
        "fields_finite": bool(np.isfinite(p["u"]).all()),
    }
    out["all_checks_pass"] = all(out["checks"].values())
    return out


def report(run_dir: Path, summary: dict) -> str:
    """The markdown report: the summary as a JSON block."""
    return (f"# Glow march: {run_dir.name}\n\n```json\n"
            f"{json.dumps(summary, indent=2)}\n```\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.glow_report",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir", type=Path)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--file-input", type=Path, default=None,
                    help="the glow's input tree (default: the synthetic "
                         "argon tree, generated into a temporary "
                         "directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    args = ap.parse_args(argv)
    check_device(args.device)
    p = profiles(args.run_dir, args.nx, args.ny, args.file_input,
                 args.device)
    md = report(args.run_dir, analyze(p))
    print(md)
    if args.out:
        args.out.write_text(md)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
