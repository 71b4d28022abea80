"""Extended reaction scheme at scale: tens of species, stepped under the
DOF-partitioned domain decomposition.

The counterpart of the JAX package's `examples/extended_scheme.py`
(BASELINE.json configuration 5, "streamer/discharge with an extended
reaction scheme (tens of species)"): the equations are generated from a
parsed chemistry tree (`models.generic.PlasmaModel`, the loop over the
species that the reference's glow script writes in UFL), here an
`--species`-species synthetic argon tree, and the coupled system is
distributed by `PlasmaModel.distribute` over `--devices` parts with halo
exchange (`parallel.dd`). The defaults are the JAX example's: 18 species,
19 equations per node, a crossed 32 x 64 mesh, float64, no multigrid,
quadrature degree 2, one advance and then `--steps` more, each preceded by
the coefficient update at the last accepted state.

`--devices N` means N parts and `--cards R` R ranks, one process per
card (`parallel.ranks`: NCCL on CUDA, rank r on card r; gloo processes
with `--device cpu`), each holding N/R parts stacked: R must divide N.
`--cards 1` (the default) runs the same ranked code in this process, with
all N parts on the one device. Rank 0 prints the JAX example's lines (and,
over more than one card, the card count); every rank prints its step
times on stderr. Without a GPU the entry point exits 1 unless given
`--device cpu`; asking for more cards than there are exits 1 too. A
generated tree lives in a temporary directory removed at exit.

Usage: python -m fedm_tpu_torch.examples.extended_scheme [--species N]
       [--devices N] [--cards R] [--nx NX] [--ny NY] [--steps N]
       [-i FILE_INPUT] [--device DEVICE]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

from .._device import check_device
from ..devtime import card_of, on_card
from ..parallel import ranks


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.examples.extended_scheme",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--species", type=int, default=18,
                    help="total species count (n_excited + 5)")
    ap.add_argument("--devices", type=int, default=1,
                    help="parts of the domain decomposition (1: no "
                         "decomposition), stacked on --device or split "
                         "over --cards")
    ap.add_argument("--cards", type=int, default=1,
                    help="ranks, one process per card (gloo processes on "
                         "the CPU); must divide --devices")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("-i", "--file-input", type=Path, default=None,
                    help="existing reference-format file_input tree "
                         "(default: generate the synthetic one)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def build_model(args: argparse.Namespace, base: Path, model_name: str,
                device=None):
    """The example's `PlasmaModel` on the tree `base/model_name`: the JAX
    example's configuration, on `device` (default `args.device`)."""
    from ..models.generic import PlasmaConfig, PlasmaModel

    cfg = PlasmaConfig(model=model_name, file_input=base, nx=args.nx,
                       ny=args.ny, mg_levels=0, quad_degree=2)
    return PlasmaModel(cfg, device=args.device if device is None
                       else device)


def run(args: argparse.Namespace, base: Path, model_name: str, group):
    """Build the model on `base/model_name`, distribute it over the ranks
    of `group` (`parallel.ranks`; this rank's parts on its device), and
    take one advance and then `args.steps` more; rank 0 prints the JAX
    example's lines. Returns (model, distributed system or None, final
    state)."""
    device = group.device
    say = print if group.rank == 0 else (lambda *a, **k: None)
    m = build_model(args, base, model_name, device)
    n_unknowns = m.space.n_dofs * m.n_eq
    say(f"{m.n_species} species, {m.n_eq} equations/node, "
        f"{m.space.n_dofs} dofs = {n_unknowns} unknowns, "
        f"{m.P_mat.shape[0]} reactions", flush=True)

    dsys = None
    if args.devices > 1:
        dsys = m.distribute(ranks.part_devices(args.devices, group), group)
        say(f"distributed over {args.devices} devices: "
            f"{dsys.n_own_max} own + {dsys.n_ghost_max} ghost rows/dev",
            flush=True)
        if dsys.n_ranks > 1:
            say(f"on {dsys.n_ranks} cards, one rank each: "
                f"{dsys.n_local} parts a card", flush=True)

    driver = m.make_driver()
    state = m.initial_state()
    aux = m._update_aux(state.u)
    state, first = on_card(lambda: driver.advance(state, aux), device)
    say(f"first step (incl. compile): {first:.1f}s", flush=True)

    def more(state):
        for _ in range(args.steps):
            state = driver.advance(state, m._update_aux(state.u))
        return state

    state, wall = on_card(lambda: more(state), device)
    dt_step = wall / args.steps
    print(f"rank {group.rank} on {card_of(device)}: first step {first:.2f} s, "
          f"then {dt_step:.3f} s/step", file=sys.stderr, flush=True)
    u = dsys.from_dist(state.u) if dsys else state.u.cpu().numpy()
    ie = m.ie
    say(f"{state.n_accepted} accepted steps to t={state.t:.3e} "
        f"({state.n_rejected} rejected), {dt_step:.2f} s/step, "
        f"ne_max={np.exp(u[:, ie]).max():.3e} m^-3, "
        f"eps_mean={np.exp(u[:, 0] - u[:, ie]).mean():.2f} eV, "
        f"finite: {np.isfinite(u).all()}", flush=True)
    return m, dsys, state


def _rank_run(group, args: argparse.Namespace, base: Path,
              model_name: str) -> dict:
    """One rank's run; what it returns crosses processes."""
    _, _, state = run(args, base, model_name, group)
    return {"rank": group.rank, "card": card_of(group.device),
            "n_accepted": state.n_accepted, "t": state.t}


def main(argv=None) -> list:
    """The example on `--cards` ranks; returns each rank's summary."""
    args = parse_args(argv)
    check_device(args.device)
    try:
        ranks.check_cards(args.cards, args.device, args.devices)
    except ValueError as e:
        sys.exit(f"--cards {args.cards}, --devices {args.devices}: {e}")
    if args.file_input is not None:
        return ranks.ranked(_rank_run, args.cards, args.device,
                            (args, args.file_input.parent,
                             args.file_input.name))
    from ..models.argon_synth import generate_argon_n_input

    with tempfile.TemporaryDirectory(prefix="argon_n_input_") as tmp:
        root = generate_argon_n_input(Path(tmp), n_excited=args.species - 5)
        print(f"generated {args.species}-species synthetic tree at {root}",
              flush=True)
        return ranks.ranked(_rank_run, args.cards, args.device,
                            (args, Path(tmp), root.name))


if __name__ == "__main__":
    main()
