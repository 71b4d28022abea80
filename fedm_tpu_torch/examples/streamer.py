"""Positive streamer benchmark run (Bagheri et al. PSST 27 (2018) 095002).

The counterpart of the JAX package's `examples/streamer.py` (and of the
reference's `examples/streamer_discharge/fedm-streamer.py`): LFA coupled
ions/electrons/Poisson with adaptive BDF2 + PID, time-interpolated PVD
output of densities and potential, the error trajectory in the
reference's `relative error.log` format.

Usage: python -m fedm_tpu_torch.examples.streamer [-o OUTPUT_DIR]
       [--quick] [--f32] [-T T_FINAL] [--device DEVICE]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..io import files, log, mesh_statistics, output_files
from ..io.output import OutputSeries, file_output
from ..models.streamer import StreamerConfig, StreamerModel
from ._tof import check_device, set_output_dir


def main(output_dir=None, quick=False, f32=False, T_final=None,
         device="cuda"):
    check_device(device)
    set_output_dir(output_dir)
    kw = {"dtype": torch.float32} if f32 else {}
    if quick:
        cfg = StreamerConfig(nx=32, ny=64, T_final=1e-10, **kw)
    else:
        cfg = StreamerConfig(**kw)
    if T_final is not None:
        cfg.T_final = T_final

    model = StreamerModel(cfg, device=device)
    log("conditions", files.model_log, cfg.dt_init, cfg.U_w, cfg.p0,
        cfg.box_height, cfg.N0, cfg.Tgas)
    mesh_statistics(model.mesh)
    log("initial time", files.model_log, 0.0)

    vtk_u = output_files("pvd", "number density", ["Ions", "electrons"])
    vtk_phi = output_files("pvd", "potential", ["Phi"])
    series = [
        OutputSeries(vtk_phi[0], lambda u: np.exp(u[:, 2]) * 0 + u[:, 2],
                     kind="pvd", field_name="Phi"),
        OutputSeries(vtk_u[0], lambda u: np.exp(u[:, 0]), kind="pvd",
                     field_name="Ions"),
        OutputSeries(vtk_u[1], lambda u: np.exp(u[:, 1]), kind="pvd",
                     field_name="electrons"),
    ]
    t_output_list = [1e-11, 1e-10, 1e-9]
    t_output_step_list = [1e-11, 1e-10, 1e-9]
    t_out, step = t_output_step_list[0], t_output_list[0]

    driver = model.make_driver(error_log=files.error_file, verbose=True)
    state = model.initial_state()
    while abs(state.t - cfg.T_final) / cfg.T_final > 1e-6:
        t_old = state.t
        state = driver.advance(state, {})
        log("time", files.model_log, state.t)
        t_out, step = file_output(
            state.t, t_old, t_out, step, t_output_list, t_output_step_list,
            series, state.u, state.u_old, mesh=model.mesh)
    print(f"Finished: {state.n_accepted} steps ({state.n_rejected} rejected)")
    return state


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m fedm_tpu_torch.examples.streamer",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("-o", "--output-dir", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("-T", "--T-final", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (default cuda)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.output_dir, args.quick, args.f32, args.T_final, args.device)
