"""Scale run of the DOF-partitioned domain decomposition: a large streamer
mesh (default 280 x 560, 157,641 dofs, 472,923 unknowns) stepped on
`--devices` parts, with the halo metadata and each step's wall time, then
the same steps undistributed for comparison (the port of the JAX
package's `tools/dd_scale.py`).

`--devices N` means N parts and `--cards R` R ranks, one process per card
(`parallel.ranks`: NCCL on CUDA, gloo processes with `--device cpu`), each
holding N/R parts stacked; `--cards 1` (the default) runs the ranked code
in this process, every part on the one device. Rank 0 prints, and steps
the undistributed model after the distributed run; every rank prints its
step times and its card on stderr. The configuration is
`StreamerConfig(nx, ny, mg_levels=1)`: no multigrid, the node-block
preconditioner alone, float64. Without a GPU the run exits 1 unless given
`--device cpu`; asking for more cards than there are exits 1 too.

Usage: python -m fedm_tpu_torch.dd_scale [--nx 280 --ny 560] [--steps 2]
       [--devices 8] [--cards R] [--device DEVICE]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ._device import check_device
from .devtime import card_of, on_card
from .models.streamer import StreamerConfig, StreamerModel
from .parallel import ranks


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m fedm_tpu_torch.dd_scale",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--nx", type=int, default=280)
    ap.add_argument("--ny", type=int, default=560)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--devices", type=int, default=8,
                    help="parts of the decomposition, stacked on --device "
                         "or split over --cards")
    ap.add_argument("--cards", type=int, default=1,
                    help="ranks, one process per card (gloo processes on "
                         "the CPU); must divide --devices")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def _steps(model, n: int, device, label: str = "", rank: int = 0) -> list:
    """Initial state, then `n` accepted steps with the verbose driver
    (rank 0 prints); returns per step (t, wall s, step error)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    driver = model.make_driver(verbose=rank == 0)
    state, wall = on_card(model.initial_state, device)
    say(f"{label}initial state ({wall:.1f}s); stepping...", flush=True)
    out = []
    for _ in range(n):
        state, wall = on_card(lambda: driver.advance(state, {}), device)
        out.append((state.t, wall, state.max_error[0]))
        say(f"{label}accepted step to t={state.t:.3e} ({wall:.1f}s wall)",
            flush=True)
    say(f"{label}step errors: {[e for _, _, e in out]}", flush=True)
    return out, state


def run(group, args: argparse.Namespace) -> dict:
    """The run on the ranks of `group` (`parallel.ranks`: this rank's parts
    on its card); returns what it printed, as numbers, on rank 0, and this
    rank's step times on the others."""
    rank, device = group.rank, group.device
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = StreamerConfig(nx=args.nx, ny=args.ny, mg_levels=1)
    model = StreamerModel(cfg, device=device)
    n_dofs = model.system.n_dofs
    n_unknowns = n_dofs * model.n_eq
    say(f"mesh {args.nx}x{args.ny}: {n_dofs} dofs, {n_unknowns} unknowns "
        f"({n_unknowns / 56000:.1f}x bench)", flush=True)
    t0 = time.perf_counter()
    dsys = model.distribute(ranks.part_devices(args.devices, group), group)
    setup = time.perf_counter() - t0
    where = (f"on {args.device}" if dsys.n_ranks == 1
             else f"on {dsys.n_ranks} cards")
    say(f"partition: {dsys.n_own_max} own + {dsys.n_ghost_max} ghost "
        f"rows/device ({dsys.n_ghost_max / dsys.n_own_max:.1%} halo; "
        f"{args.devices} parts {where}, {setup:.1f}s)", flush=True)
    steps, state = _steps(model, args.steps, device, rank=rank)
    card = card_of(device)
    for k, (_, wall, _) in enumerate(steps):
        print(f"rank {rank} step {k + 1}: {wall:.3f} s on {card}",
              file=sys.stderr, flush=True)
    u = torch.as_tensor(dsys.from_dist(state.u))
    if not bool(torch.isfinite(u).all()):
        raise RuntimeError("the distributed state is not finite")
    if rank != 0:
        return {"rank": rank, "card": card,
                "step_s": [w for _, w, _ in steps]}
    print(f"OK: {state.n_accepted} steps, state finite, "
          f"err={state.max_error[0]:.3e}", flush=True)
    single = StreamerModel(cfg, device=device)
    undist, st1 = _steps(single, args.steps, device, "undistributed: ")
    cards = "" if dsys.n_ranks == 1 else f" ({dsys.n_ranks} cards)"
    for k, ((_, a, _), (_, b, _)) in enumerate(zip(steps, undist)):
        print(f"step {k + 1}: {a:.2f}s on {args.devices} parts, "
              f"{b:.2f}s undistributed{cards}", flush=True)
    if torch.device(device).type == "cuda":
        from .ops.ell_scatter import LAUNCHES

        print(f"K1 launches: {sum(LAUNCHES.values())}", flush=True)
    return {"rank": rank, "card": card, "dofs": n_dofs,
            "unknowns": n_unknowns, "n_own_max": dsys.n_own_max,
            "n_ghost_max": dsys.n_ghost_max, "steps": steps, "u": u,
            "step_s": [w for _, w, _ in steps], "undistributed": undist,
            "u_undistributed": st1.u.cpu()}


def main(argv=None) -> dict:
    """The run on `--cards` ranks; returns rank 0's numbers."""
    args = parse_args(argv)
    check_device(args.device)
    try:
        ranks.check_cards(args.cards, args.device, args.devices)
    except ValueError as e:
        sys.exit(f"--cards {args.cards}, --devices {args.devices}: {e}")
    return ranks.ranked(run, args.cards, args.device, (args,))[0]


if __name__ == "__main__":
    main()
