"""A run's checkpoint trail as ParaView series (the port of the JAX
package's `tools/export_series.py`, same flags and files).

The reference's production scripts write PVD time series of the number
densities and the potential (`fedm/file_io.py:538-616`). This entry point
turns the npz checkpoints of a run (either package's: the format is
shared) into the reference's dolfin-File layout with one snapshot per
checkpoint:
- `--model streamer`: one combined binary VTU per snapshot (electrons,
  ions, potential and |E|, float32 points) and `fields.pvd`. Each
  snapshot carries its own mesh, rebuilt from the corridor in the
  checkpoint's meta (a moving window's checkpoints live on different
  corridors).
- `--model glow`: one series per field (`<out>/<name>/<name>.pvd` and
  numbered VTUs): energy density, Ar*, Ar+, electrons, potential, mean
  energy.

Only the mesh and the state layout are read from the models, and neither
depends on the transport or rate tables. So the glow's input tree is
`--file-input DIR` where given, else the synthetic argon tree
(`models.argon_synth`) generated into a temporary directory removed at
exit.

    python -m fedm_tpu_torch.export_series --run DIR --model streamer|glow
        --out DIR [--max-snapshots N] [--file-input DIR] [--device cuda]

The models are built on `--device` (default cuda); without a GPU it exits
1 unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import contextlib
import tempfile
from pathlib import Path

import numpy as np
import torch

from ._device import check_device


def checkpoint_trail(run: Path, device="cuda"):
    """(t-sorted) [(path, state, meta)] for the run's checkpoint files,
    one per (t, n_accepted)."""
    from .io.checkpoint import load_checkpoint

    paths = sorted(run.glob("checkpoint_*.npz")) + [run / "checkpoint.npz"]
    out = []
    seen = set()
    for p in paths:
        if not p.exists():
            continue
        st, meta = load_checkpoint(p, device=device, with_meta=True)
        key = (st.t, st.n_accepted)
        if key in seen:
            continue
        seen.add(key)
        out.append((p, st, meta))
    out.sort(key=lambda r: r[1].t)
    return out


def streamer_mesh(meta, device="cuda"):
    """The checkpoint's streamer model, rebuilt from its corridor, tails
    and wall in `meta`."""
    from .models.streamer import StreamerConfig, StreamerModel

    corridor = tuple(float(v) for v in meta["z_corridor"])
    tails = (tuple(int(v) for v in meta["z_tail_cells"])
             if "z_tail_cells" in meta else (48, 48))
    wall = float(meta["z_wall_dz"]) if "z_wall_dz" in meta else None
    # the default mg_levels: the corridor line counts are rounded to the
    # V-cycle hierarchy's multiples, so another value changes the node
    # count and the checkpoint no longer fits the mesh
    cfg = StreamerConfig(dtype=torch.float32, nx=96, z_corridor=corridor,
                         z_tail_cells=tails, z_wall_dz=wall,
                         r_corridor=(2e-3, 2e-5))
    return StreamerModel(cfg, device=device)


def export_streamer(run: Path, out: Path, max_snapshots: int = 0,
                    device="cuda"):
    """One combined binary VTU per snapshot (the four fields share one
    copy of the mesh, float32 points) and `fields.pvd`, rewritten after
    each snapshot; one model per (corridor, tails)."""
    from .io.vtu import write_vtu

    snapshots = []
    cache = {}
    trail = checkpoint_trail(run, device)
    if max_snapshots and len(trail) > max_snapshots:
        idx = np.linspace(0, len(trail) - 1, max_snapshots).round()
        trail = [trail[int(i)] for i in idx]
    for p, st, meta in trail:
        key = (tuple(float(v) for v in meta["z_corridor"]),
               tuple(int(v) for v in meta.get("z_tail_cells", (48, 48))))
        if key not in cache:
            cache[key] = streamer_mesh(meta, device)
        model = cache[key]
        if model.space.n_dofs != st.u.shape[0]:
            print(f"  skip {p.name}: {st.u.shape[0]} dofs vs mesh "
                  f"{model.space.n_dofs}", flush=True)
            continue
        u = st.u.cpu().numpy().astype(np.float64)
        coords = np.asarray(model.space.dof_coords)
        # |E| from the P1 potential's gradient on the structured grid
        rs, zs = np.unique(coords[:, 0]), np.unique(coords[:, 1])
        order = np.lexsort((coords[:, 1], coords[:, 0]))
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        phi_g = u[order, 2].reshape(len(rs), len(zs))
        Er = np.gradient(phi_g, rs, axis=0)
        Ez = np.gradient(phi_g, zs, axis=1)
        Em = np.sqrt(Er**2 + Ez**2).reshape(-1)[inv]
        fields = {"electrons": np.exp(u[:, 1]),
                  "ions": np.exp(u[:, 0]),
                  "potential": u[:, 2],
                  "E_magnitude": Em}
        fname = f"fields{len(snapshots):06d}.vtu"
        write_vtu(out / fname, model.mesh, fields, binary=True,
                  point_dtype=np.float32)
        snapshots.append((st.t, fname))
        with open(out / "fields.pvd", "w") as f:
            f.write('<?xml version="1.0"?>\n'
                    '<VTKFile type="Collection" version="0.1" '
                    'byte_order="LittleEndian">\n  <Collection>\n')
            for t, fn in snapshots:
                f.write(f'    <DataSet timestep="{t}" part="0" '
                        f'file="{fn}" />\n')
            f.write("  </Collection>\n</VTKFile>\n")
        print(f"  {p.name}: t={st.t:.4e} ({st.n_accepted} steps, "
              f"{st.u.shape[0]} dofs)", flush=True)


@contextlib.contextmanager
def glow_input(file_input=None):
    """(file_input, model name) of the glow model: `file_input` with the
    reference's `4_particles` model, else the synthetic argon tree in a
    temporary directory removed on exit."""
    if file_input is not None:
        yield Path(file_input), "4_particles"
        return
    from .models.argon_synth import generate_argon_input

    with tempfile.TemporaryDirectory(prefix="fedm_glow_input_") as tmp:
        generate_argon_input(Path(tmp), model="argon_synth")
        yield Path(tmp), "argon_synth"


def glow_model(nx: int, ny: int, file_input=None, device="cuda"):
    """The glow model of an `nx` x `ny` run (its mesh and state layout)."""
    from .models.glow import GlowConfig, GlowDischargeModel

    with glow_input(file_input) as (tree, name):
        return GlowDischargeModel(GlowConfig(model=name, file_input=tree,
                                             nx=nx, ny=ny), device=device)


def export_glow(run: Path, out: Path, nx=64, ny=64, file_input=None,
                device="cuda"):
    """One VTU series per field of the glow's state."""
    from .io.vtu import VtuSeriesWriter

    model = glow_model(nx, ny, file_input, device)
    # the state layout (models/generic.py): u0 = ln w_e (energy density),
    # u1..u_{n-2} = ln n_i of species 1.. (the background Ar is held at N0,
    # not solved), u_{n-1} = Phi; the electrons are the last species
    names = ["energy_density", "Ar_star_density", "Ar_plus_density",
             "electrons", "potential", "mean_energy"]
    writers = {k: VtuSeriesWriter(k, out) for k in names}
    for p, st, meta in checkpoint_trail(run, device):
        if model.space.n_dofs != st.u.shape[0]:
            print(f"  skip {p.name}: dof mismatch", flush=True)
            continue
        u = st.u.cpu().numpy().astype(np.float64)
        ie = u.shape[1] - 2  # the electron column (the last species)
        fields = {"energy_density": np.exp(u[:, 0]),
                  "Ar_star_density": np.exp(u[:, 1]),
                  "Ar_plus_density": np.exp(u[:, 2]),
                  "electrons": np.exp(u[:, ie]),
                  "potential": u[:, -1],
                  "mean_energy": np.exp(u[:, 0] - u[:, ie])}
        for k, v in fields.items():
            writers[k].write(model.mesh, v, st.t, field_name=k)
        print(f"  {p.name}: t={st.t:.4e} ({st.n_accepted} steps)",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.export_series",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", type=Path, required=True)
    ap.add_argument("--model", choices=["streamer", "glow"], required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--max-snapshots", type=int, default=0,
                    help="evenly subsample the checkpoint trail "
                         "(archival size control; 0 = all)")
    ap.add_argument("--file-input", type=Path, default=None,
                    help="the glow's input tree (default: the synthetic "
                         "argon tree, generated into a temporary "
                         "directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default cuda)")
    args = ap.parse_args(argv)
    check_device(args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    if args.model == "streamer":
        export_streamer(args.run, args.out, args.max_snapshots, args.device)
    else:
        export_glow(args.run, args.out, file_input=args.file_input,
                    device=args.device)
    print(f"series written under {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
