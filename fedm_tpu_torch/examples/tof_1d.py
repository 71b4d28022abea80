"""Time-of-flight 1D verification run (method of exact solutions).

The counterpart of the JAX package's `examples/tof_1d.py` (and of the
reference's `examples/time_of_flight_1D/fedm-tof_1d.py`): drift-diffusion-
reaction for one electron swarm in log form, P2 elements on 4,000 cells,
fixed dt with a BDF1 first step then BDF2; the relative L2 error against
the exact drifting, diffusing, ionising Gaussian every 10 steps, written
to `relative error.log` in the reference's format.

Usage: python -m fedm_tpu_torch.examples.tof_1d [-o OUTPUT_DIR] [--quick]
       [--device DEVICE]
"""

from __future__ import annotations

from .._device import check_device
from ._tof import parse_args, run_and_write, set_output_dir
from ..models.tof import TimeOfFlight1D, TofConfig


def main(output_dir=None, quick=False, device="cuda"):
    check_device(device)
    set_output_dir(output_dir)
    if quick:
        cfg = TofConfig(dt=1e-11, T_final=3e-10)
        model = TimeOfFlight1D(cfg, n_cells=400, device=device)
    else:
        cfg = TofConfig(dt=1e-11, T_final=3e-9)
        model = TimeOfFlight1D(cfg, device=device)  # 4000 cells, P2
    n_out = int(round(cfg.T_final / cfg.dt)) // 10
    out_times = [k * 10 * cfg.dt for k in range(1, n_out + 1)]
    return run_and_write(model, out_times)


if __name__ == "__main__":
    args = parse_args("python -m fedm_tpu_torch.examples.tof_1d",
                      __doc__.split("\n\n")[0])
    main(args.output_dir, args.quick, args.device)
