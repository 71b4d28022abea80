"""What the two time-of-flight entry points share: the command line, the model
log, the run and its outputs, as the JAX package's `examples/tof_*.py`
write them."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..io import files, log, mesh_statistics, output_files


def parse_args(prog: str, doc: str, argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog=prog, description=doc)
    ap.add_argument("-o", "--output-dir", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


def set_output_dir(output_dir) -> None:
    if output_dir is not None:
        files.output_folder_path = Path(output_dir)


def run_and_write(model, output_times):
    """Log the model, run it to the output times, append each relative L2
    error to `relative error.log` in the reference's format, and write the
    final numerical and exact densities at the mesh vertices as PVD
    series. Returns [(t, relative error)]."""
    cfg = model.cfg
    mesh = model.space.mesh
    log("properties", files.model_log, "Air", "Time_of_flight",
        ["electrons", "analytical solution"], 9.10938356e-31,
        -1.6021766208e-19)
    log("conditions", files.model_log, cfg.dt, "None", 760.0, 1e-3,
        760.0 * 3.21877e22, 300.0)
    mesh_statistics(mesh)
    log("initial time", files.model_log, cfg.t0)

    vtk = output_files("pvd", "number density",
                       ["electrons", "analytical solution"])
    u, errors = model.run(output_times=output_times)

    h = mesh.hmax()
    for t, err in errors:
        with open(files.error_file, "a") as f:
            f.write(f"h_max = {h}\t dt = {cfg.dt}\t relative_error = {err}\n")
        print(f"t = {t:.4e}  relative_error = {err:.6e}")
    pts = torch.as_tensor(model.space.dof_coords, dtype=torch.float64,
                          device=model.device)
    n_num = np.exp(u[:, 0].cpu().numpy())[: mesh.n_verts]
    n_ex = model.n_analytic(pts, cfg.T_final).cpu().numpy()[: mesh.n_verts]
    vtk[0].write(mesh, n_num, cfg.T_final)
    vtk[1].write(mesh, n_ex, cfg.T_final)
    print("Finished")
    return errors
