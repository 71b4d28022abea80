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

`--devices N` means N parts, all on `--device`: they are stacked on that
one device (ROADMAP.md, slice 12: parts on distinct cards are not ported
yet), so the JAX example's "need N devices" has no counterpart here.
Without a GPU the entry point exits 1 unless given `--device cpu`. A
generated tree lives in a temporary directory removed at exit.

Usage: python -m fedm_tpu_torch.examples.extended_scheme [--species N]
       [--devices N] [--nx NX] [--ny NY] [--steps N] [-i FILE_INPUT]
       [--device DEVICE]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ._tof import check_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.examples.extended_scheme",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--species", type=int, default=18,
                    help="total species count (n_excited + 5)")
    ap.add_argument("--devices", type=int, default=1,
                    help="parts of the domain decomposition, all stacked "
                         "on --device (1: no decomposition)")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("-i", "--file-input", type=Path, default=None,
                    help="existing reference-format file_input tree "
                         "(default: generate the synthetic one)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_model(args: argparse.Namespace, base: Path, model_name: str):
    """The example's `PlasmaModel` on the tree `base/model_name`: the JAX
    example's configuration."""
    from ..models.generic import PlasmaConfig, PlasmaModel

    cfg = PlasmaConfig(model=model_name, file_input=base, nx=args.nx,
                       ny=args.ny, mg_levels=0, quad_degree=2)
    return PlasmaModel(cfg, device=args.device)


def run(args: argparse.Namespace, base: Path, model_name: str):
    """Build the model on `base/model_name`, distribute it, and take one
    advance and then `args.steps` more, printing the JAX example's
    lines. Returns (model, distributed system or None, final state)."""
    m = build_model(args, base, model_name)
    n_unknowns = m.space.n_dofs * m.n_eq
    print(f"{m.n_species} species, {m.n_eq} equations/node, "
          f"{m.space.n_dofs} dofs = {n_unknowns} unknowns, "
          f"{m.P_mat.shape[0]} reactions", flush=True)

    dsys = None
    if args.devices > 1:
        dsys = m.distribute([args.device] * args.devices)
        print(f"distributed over {args.devices} devices: "
              f"{dsys.n_own_max} own + {dsys.n_ghost_max} ghost rows/dev",
              flush=True)

    driver = m.make_driver()
    state = m.initial_state()
    aux = m._update_aux(state.u)
    t0 = time.perf_counter()
    state = driver.advance(state, aux)
    _sync(args.device)
    print(f"first step (incl. compile): {time.perf_counter() - t0:.1f}s",
          flush=True)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        aux = m._update_aux(state.u)
        state = driver.advance(state, aux)
    _sync(args.device)
    dt_step = (time.perf_counter() - t0) / args.steps
    u = dsys.from_dist(state.u) if dsys else state.u.cpu().numpy()
    ie = m.ie
    print(f"{state.n_accepted} accepted steps to t={state.t:.3e} "
          f"({state.n_rejected} rejected), {dt_step:.2f} s/step, "
          f"ne_max={np.exp(u[:, ie]).max():.3e} m^-3, "
          f"eps_mean={np.exp(u[:, 0] - u[:, ie]).mean():.2f} eV, "
          f"finite: {np.isfinite(u).all()}", flush=True)
    return m, dsys, state


def main(argv=None):
    args = parse_args(argv)
    check_device(args.device)
    if args.file_input is not None:
        return run(args, args.file_input.parent, args.file_input.name)
    from ..models.argon_synth import generate_argon_n_input

    with tempfile.TemporaryDirectory(prefix="argon_n_input_") as tmp:
        root = generate_argon_n_input(Path(tmp), n_excited=args.species - 5)
        print(f"generated {args.species}-species synthetic tree at {root}",
              flush=True)
        return run(args, Path(tmp), root.name)


if __name__ == "__main__":
    main()
