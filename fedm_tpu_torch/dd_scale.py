"""Scale run of the DOF-partitioned domain decomposition: a large streamer
mesh (default 280 x 560, 157,641 dofs, 472,923 unknowns) stepped on
`--devices` parts, with the halo metadata and each step's wall time, then
the same steps undistributed for comparison (the port of the JAX
package's `tools/dd_scale.py`).

`--devices N` means N parts, all on `--device`: they are stacked on that
one device (parts on distinct cards are not ported yet). The configuration
is `StreamerConfig(nx, ny, mg_levels=1)`: no multigrid, the node-block
preconditioner alone, float64. Without a GPU the run exits 1 unless given
`--device cpu`.

Usage: python -m fedm_tpu_torch.dd_scale [--nx 280 --ny 560] [--steps 2]
       [--devices 8] [--device DEVICE]
"""

from __future__ import annotations

import argparse
import time

import torch

from .examples._tof import check_device
from .models.streamer import StreamerConfig, StreamerModel


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m fedm_tpu_torch.dd_scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=280)
    ap.add_argument("--ny", type=int, default=560)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--devices", type=int, default=8,
                    help="parts of the decomposition, all stacked on "
                         "--device")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _steps(model, n: int, device, label: str = "") -> list:
    """Initial state, then `n` accepted steps with the verbose driver;
    returns per step (t, wall s, step error)."""
    driver = model.make_driver(verbose=True)
    t0 = time.perf_counter()
    state = model.initial_state()
    _sync(device)
    print(f"{label}initial state ({time.perf_counter() - t0:.1f}s); "
          f"stepping...", flush=True)
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        state = driver.advance(state, {})
        _sync(device)
        wall = time.perf_counter() - t0
        out.append((state.t, wall, state.max_error[0]))
        print(f"{label}accepted step to t={state.t:.3e} ({wall:.1f}s wall)",
              flush=True)
    print(f"{label}step errors: {[e for _, _, e in out]}", flush=True)
    return out, state


def run(args: argparse.Namespace) -> dict:
    """The run; returns what it printed, as numbers."""
    cfg = StreamerConfig(nx=args.nx, ny=args.ny, mg_levels=1)
    model = StreamerModel(cfg, device=args.device)
    n_dofs = model.system.n_dofs
    n_unknowns = n_dofs * model.n_eq
    print(f"mesh {args.nx}x{args.ny}: {n_dofs} dofs, {n_unknowns} unknowns "
          f"({n_unknowns / 56000:.1f}x bench)", flush=True)
    t0 = time.perf_counter()
    dsys = model.distribute([args.device] * args.devices)
    setup = time.perf_counter() - t0
    print(f"partition: {dsys.n_own_max} own + {dsys.n_ghost_max} ghost "
          f"rows/device ({dsys.n_ghost_max / dsys.n_own_max:.1%} halo; "
          f"{args.devices} parts on {args.device}, {setup:.1f}s)",
          flush=True)
    steps, state = _steps(model, args.steps, args.device)
    u = torch.as_tensor(dsys.from_dist(state.u))
    if not bool(torch.isfinite(u).all()):
        raise RuntimeError("the distributed state is not finite")
    print(f"OK: {state.n_accepted} steps, state finite, "
          f"err={state.max_error[0]:.3e}", flush=True)
    single = StreamerModel(cfg, device=args.device)
    undist, st1 = _steps(single, args.steps, args.device, "undistributed: ")
    for k, ((_, a, _), (_, b, _)) in enumerate(zip(steps, undist)):
        print(f"step {k + 1}: {a:.2f}s on {args.devices} parts, "
              f"{b:.2f}s undistributed", flush=True)
    if torch.device(args.device).type == "cuda":
        from .ops.ell_scatter import LAUNCHES

        print(f"K1 launches: {sum(LAUNCHES.values())}", flush=True)
    return {"dofs": n_dofs, "unknowns": n_unknowns,
            "n_own_max": dsys.n_own_max, "n_ghost_max": dsys.n_ghost_max,
            "steps": steps, "u": u, "undistributed": undist,
            "u_undistributed": st1.u.cpu()}


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_device(args.device)
    return run(args)


if __name__ == "__main__":
    main()
