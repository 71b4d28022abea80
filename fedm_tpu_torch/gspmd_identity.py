"""Sharded-production identity on the port: `tools/gspmd_identity.py` of the
JAX package, with R ranks on z-slabs (`CoupledSystem.use_gspmd`, one rank
per card) in place of 8 virtual devices.

Loads a checkpoint of the Bagheri production configuration and marches N
accepted steps of the whole production stack (host-loop Newton with the
float64 defect, structured assembly, the mg-zline V-cycle, the density
floor, predictor 1.0, fail-dt cap 0.7) twice: on one card, and on R
ranks, each holding a z-slab; then checks trajectory identity (the same
accepted count, t within rtol 1e-9, fields allclose at rtol 5e-4, atol
1e-6) and writes the evidence JSON, with the JAX tool's keys (its `8dev`
keys hold the R-rank run).

The model comes from the checkpoint: with the window's geometry in its
meta (`z_corridor`, `z_tail_cells`), the bagheri14 protocol on that
window, as the JAX tool builds it; without (the restart checkpoint
`bench_assets/bagheri_dz1e-5_ckpt.npz`), `bench.py`'s restart
configuration on the static corridor (0, 1.08e-2) at dz 1e-5.
`march(group, spec)` runs one march from such a model spec
(`parallel.rank_checks.slab_model`), so other callers can march any
structured configuration.

    python -m fedm_tpu_torch.gspmd_identity [--ckpt PATH] [--steps 5]
        [--devices 4] [--device cuda] [--out gspmd_identity.json]

On the CPU (`--device cpu`) the ranks are gloo processes.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

DEFAULT_CKPT = Path("runs/bagheri14_ref/checkpoint_004500.npz")
FIELD_RTOL, FIELD_ATOL, T_RTOL = 5e-4, 1e-6, 1e-9


def spec_for(ckpt: Path, steps: int) -> dict:
    """The march's model spec for checkpoint `ckpt` (module docstring):
    N advances with the production driver options."""
    from .io.checkpoint import load_checkpoint

    _, meta = load_checkpoint(ckpt, device="cpu", with_meta=True)
    if "z_corridor" in meta:
        corridor = tuple(float(v) for v in meta["z_corridor"])
        tails = (tuple(int(v) for v in meta["z_tail_cells"])
                 if "z_tail_cells" in meta else (48, 48))
        newton = dict(rtol=1e-3, max_iter=20, linear_tol=1e-2,
                      linear_maxiter=400, linear_solver="bicgstab",
                      accept_reduction=3e-2, host_loop=True,
                      hi_residual=True, true_res_rescue=1.0)
        cfg = dict(nx=96, z_corridor=corridor, stab_mode="off",
                   poisson_precond="mg-zline", T_final=1.4e-8,
                   z_tail_cells=tails, r_corridor=(2e-3, 2e-5),
                   density_floor=1e13)
    else:   # bench.py's restart (bench.py:88-110)
        newton = dict(rtol=1e-3, max_iter=20, linear_tol=3e-2,
                      linear_maxiter=400, accept_reduction=3e-2,
                      host_loop=True, hi_residual=True)
        cfg = dict(nx=96, z_corridor=(0.0, 1.08e-2, 1e-5),
                   poisson_precond="mg-zline", density_floor=1e13,
                   r_corridor=(2e-3, 2e-5), stab_mode="off")
    return {"cfg": cfg, "newton": newton, "float32": True,
            "ckpt": str(ckpt), "plan": ["advance"] * int(steps),
            "driver": {"fail_dt_cap": 0.7, "predictor": 1.0}}


def march(group, spec: dict) -> dict:
    """One march of `spec` (`rank_checks.slab_march`): on one card
    without a group (spec `device`), else on this rank's z-slab."""
    from .parallel.rank_checks import slab_march

    return slab_march(group, spec)


def trajectory(res: dict) -> list:
    return [dict(t=r["t"], dt=r["dt"], n_accepted=r["n_accepted"],
                 n_rejected=r["n_rejected"], wall_s=r["s"])
            for r in res["rows"]]


def identity(one: dict, many: list) -> dict:
    """The JAX tool's comparison of the one-card march `one` with the
    ranks' marches `many` (rank order; rank 0 holds the gathered state)."""
    u1 = one["u"].numpy()
    uR = many[0]["u"].numpy()
    r1, rR = one["rows"], many[0]["rows"]
    rel = float((np.abs(uR - u1) / (np.abs(u1) + 1e-12)).max())
    dt_dev = max(abs(a["dt"] - b["dt"]) / b["dt"] for a, b in zip(rR, r1))
    acc = rR[-1]["n_accepted"] == r1[-1]["n_accepted"]
    ok = (acc and bool(np.isclose(rR[-1]["t"], r1[-1]["t"], rtol=T_RTOL))
          and bool(np.allclose(uR, u1, rtol=FIELD_RTOL, atol=FIELD_ATOL)))
    return {"accepted_equal": bool(acc),
            "t_final_1dev": float(r1[-1]["t"]),
            "t_final_8dev": float(rR[-1]["t"]),
            "max_rel_field_dev": rel, "max_rel_dt_dev": float(dt_dev),
            "trajectory_1dev": trajectory(one),
            "trajectory_8dev": trajectory(many[0]),
            "rank_wall_s": [[r["s"] for r in m["rows"]] for m in many],
            "identity_ok": bool(ok)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.gspmd_identity",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", type=Path, default=DEFAULT_CKPT)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--devices", type=int, default=4,
                    help="ranks of the sharded march, one card each")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu: gloo ranks)")
    ap.add_argument("--out", type=Path, default=Path("gspmd_identity.json"))
    args = ap.parse_args(argv)

    from .io.checkpoint import load_checkpoint
    from .parallel import ranks

    ranks.check_cards(args.devices, args.device)
    state0 = load_checkpoint(args.ckpt, device="cpu")
    spec = spec_for(args.ckpt, args.steps)
    print(f"checkpoint {args.ckpt}: t={state0.t:.6e} dt={state0.dt:.3e} "
          f"steps={state0.n_accepted} config={spec['cfg']}", flush=True)
    print("=== one-card march ===", flush=True)
    one = march(None, {**spec, "device": args.device})
    print(f"=== {args.devices}-rank z-slab march ===", flush=True)
    many = ranks.ranked(march, args.devices, args.device, (spec,))
    n = state0.u.shape[0]
    result = {"checkpoint": str(args.ckpt), "t_start": float(state0.t),
              "n_dofs": int(n), "n_unknowns": int(n * state0.u.shape[1]),
              "devices": args.devices, "steps": args.steps,
              **identity(one, many)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"identity_ok={result['identity_ok']} max_rel_field_dev="
          f"{result['max_rel_field_dev']:.3e} max_rel_dt_dev="
          f"{result['max_rel_dt_dev']:.3e} -> {args.out}", flush=True)
    return 0 if result["identity_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
