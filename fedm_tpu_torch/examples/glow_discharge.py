"""Argon glow discharge run (LMEA, parsed reaction scheme).

The counterpart of the JAX package's `examples/glow_discharge.py` (and of
the reference's `examples/glow_discharge/fedm-gd.py`): the
speclist/reacscheme/LUT front-end, semi-implicit coefficients, the
electron energy equation, secondary emission, the ramped cathode voltage,
adaptive BDF2 with PID, XDMF/HDF5 checkpoint output of the densities and
PVD of the potential, reaction-matrix and conditions logging, and the
final state as `checkpoint.npz`.

By default generates the synthetic argon input tree
(`fedm_tpu_torch.models.argon_synth`); pass `-i` to point at an existing
reference-format `file_input` directory. The XDMF/HDF5 output needs
`h5py`: without it the run stops with ImportError before it steps, and no
other format is written in its place.

Usage: python -m fedm_tpu_torch.examples.glow_discharge [-i FILE_INPUT]
       [-o OUTPUT_DIR] [--quick] [-T T_FINAL] [--device DEVICE]
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from ..io import files, log, mesh_statistics, output_files
from ..io.checkpoint import save_checkpoint
from ..io.output import OutputSeries, file_output
from ..models.glow import GlowConfig, GlowDischargeModel
from .._device import check_device
from ._tof import set_output_dir


def main(file_input=None, output_dir=None, quick=False, T_final=None,
         device="cuda"):
    check_device(device)
    set_output_dir(output_dir)
    if file_input is None:
        from ..models.argon_synth import generate_argon_input

        file_input = Path(tempfile.mkdtemp(prefix="argon_input_"))
        generate_argon_input(file_input)
        print(f"generated synthetic argon input tree at {file_input}")

    if quick:
        cfg = GlowConfig(file_input=file_input, nx=24, ny=24, ttol=2e-3,
                         T_final=1e-11)
    else:
        cfg = GlowConfig(file_input=file_input)
    if T_final is not None:
        cfg.T_final = T_final

    model = GlowDischargeModel(cfg, device=device)
    log("conditions", files.model_log, cfg.dt_init, cfg.U_w, cfg.p0,
        cfg.gap_length, cfg.N0, cfg.Tgas)
    log("properties", files.model_log, "Ar", cfg.model, model.species,
        model.masses, model.signs)
    log("matrices", files.model_log, model.G_mat, model.L_mat, model.P_mat)
    mesh_statistics(model.mesh)
    log("initial time", files.model_log, 0.0)

    names = ["Ar_star", "Ar_plus", "electrons"]
    xdmf = output_files("xdmf", "number density", names, mesh=model.mesh)
    vtk_phi = output_files("pvd", "potential", ["Phi"])
    series = [OutputSeries(vtk_phi[0], lambda u: u[:, 4], kind="pvd",
                           field_name="Phi")]
    for k, (w, name) in enumerate(zip(xdmf, names)):
        series.append(OutputSeries(
            w, lambda u, k=k: np.exp(u[:, k + 1]), kind="xdmf"))

    t_output_list = [1e-11, 1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5]
    t_output_step_list = [1e-11, 1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-6]
    t_out, step = t_output_step_list[0], t_output_list[0]

    driver = model.make_driver(error_log=files.error_file, verbose=True)
    state = model.initial_state()
    while state.t < cfg.T_final:
        t_old = state.t
        aux = model._update_aux(state.u)
        state = driver.advance(state, aux)
        log("time", files.model_log, state.t)
        t_out, step = file_output(
            state.t, t_old, t_out, step, t_output_list, t_output_step_list,
            series, state.u, state.u_old, mesh=model.mesh, unit="us")
    save_checkpoint(files.output_folder_path / "checkpoint.npz", state)
    print(f"Finished: {state.n_accepted} steps ({state.n_rejected} rejected), "
          f"checkpoint written")
    return state


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.examples.glow_discharge",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("-i", "--file-input", default=None)
    ap.add_argument("-o", "--output-dir", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("-T", "--T-final", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.file_input, args.output_dir, args.quick, args.T_final,
         args.device)
