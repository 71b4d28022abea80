"""Reference numbers for the PyTorch port's chip smoke test.

Evaluates, with the JAX package on the CPU, the float64 residual (the
`hi_residual` defect Newton starts from) of the bench configuration
(`bench.py:_stiff_bench`) at the state of the bench checkpoint: the first
attempted step of the restart, delta = 0. Prints the per-equation 2-norms,
which `chip_smoke.py` holds the port's residual on the card to.

    JAX_PLATFORMS=cpu python tools/port_reference_norms.py
"""

import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import fedm_tpu  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from fedm_tpu.io.checkpoint import load_checkpoint  # noqa: E402
from fedm_tpu.model.system import StepParams  # noqa: E402
from fedm_tpu.models.streamer import StreamerConfig, StreamerModel  # noqa: E402
from fedm_tpu.solvers.newton import NewtonConfig  # noqa: E402

CKPT = Path(__file__).resolve().parent.parent / "bench_assets" / \
    "bagheri_dz1e-5_ckpt.npz"


def main():
    nc = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=3e-2,
                      linear_maxiter=400, accept_reduction=3e-2,
                      host_loop=True, hi_residual=True)
    cfg = StreamerConfig(dtype=jnp.float32, newton=nc, nx=96,
                         z_corridor=(0.0, 1.08e-2, 1e-5),
                         poisson_precond="mg-zline", density_floor=1e13,
                         r_corridor=(2e-3, 2e-5), stab_mode="off")
    model = StreamerModel(cfg)
    model.system.use_gather_scatter()
    s = load_checkpoint(CKPT)
    params = StepParams(jnp.asarray(s.t + s.dt), jnp.asarray(s.dt),
                        jnp.asarray(s.dt_old))
    # AdaptiveDriver.advance rotates the history first: u_old <- u,
    # u_old1 <- u_old
    R = model.system._make_hi_residual(s.u, s.u_old, {}, params)
    F = np.asarray(R(jnp.zeros(s.u.shape, jnp.float32)))
    print("n_dofs", F.shape[0])
    print("per-equation residual 2-norms:",
          [float(np.linalg.norm(F[:, k])) for k in range(F.shape[1])])


if __name__ == "__main__":
    main()
