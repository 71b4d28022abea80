"""Time-of-flight 2D (axisymmetric) verification run.

The counterpart of the JAX package's `examples/tof_2d.py` (the reference's
`tests/integrated_tests/time_of_flight/fedm_tof.py:63-95`): a point-source
electron swarm drifting along z in cylindrical (r, z), P1 elements on a
40 x 40 mesh over 2.5e-4 x 5e-4 m, dt = 1e-12, t in [2.5e-9, 2.6e-9]; the
relative L2 error against the 3D Gaussian exact solution, written to
`relative error.log` in the reference's format. The reference pins
0.128997 for this configuration.

Usage: python -m fedm_tpu_torch.examples.tof_2d [-o OUTPUT_DIR] [--quick]
       [--device DEVICE]
"""

from __future__ import annotations

from .._device import check_device
from ._tof import parse_args, run_and_write, set_output_dir
from ..models.tof import TimeOfFlight2D, TofConfig


def main(output_dir=None, quick=False, device="cuda"):
    check_device(device)
    set_output_dir(output_dir)
    if quick:
        cfg = TofConfig(t0=2.5e-9, T_final=2.52e-9, dt=1e-12)
        model = TimeOfFlight2D(cfg, nx=20, ny=20, device=device)
    else:
        model = TimeOfFlight2D(device=device)  # 40 x 40, P1
    return run_and_write(model, [model.cfg.T_final])


if __name__ == "__main__":
    args = parse_args("python -m fedm_tpu_torch.examples.tof_2d",
                      __doc__.split("\n\n")[0])
    main(args.output_dir, args.quick, args.device)
