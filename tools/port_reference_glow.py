"""Reference numbers for the PyTorch port's glow smoke phase.

Builds, with the JAX package on the CPU, the argon glow discharge at the
`glow50` protocol of `tools/glow_run.py` (float32 compute with the float64
defect, host-driven Newton, rtol 1e-3, linear_tol 1e-2, linear_maxiter
600) on the synthetic argon tree (`fedm_tpu.models.argon_synth`, generated
into a temporary directory) and a crossed 64 x 64 mesh, then:

  1. its initial state: the per-column 2-norms of u = [ln w_e, ln n_Ar*,
     ln n_Ar+, ln n_e, Phi], and the per-equation 2-norms of the float64
     residual of the first attempted step (delta = 0, dt = dt_init), with
     the coefficients `_update_aux` gives at that state;
  2. a probe state (the initial one with the potential of a cathode fall,
     U_w (1 - z/L)^2, and log-densities modulated by 0.5 sin(pi z/L)
     cos(pi r/(2 R))): the per-column 2-norms of `_update_aux`'s reduced
     field, rate coefficients k, mobilities mu and diffusivities D there,
     and the per-equation 2-norms of the float64 residual of a step from
     it (u = u_old = u_old1 = probe, t = dt = 1e-12, BDF1).

Prints one JSON line, which `chip_smoke.py` holds the port to on the card.
With --port it then runs the same steps with the PyTorch port on the CPU
and prints a second JSON line: the port's relative gaps to those numbers
and the gaps of the port's residuals evaluated in float32 (no float64
defect), a lower-precision result that `chip_smoke.py`'s residual
tolerances must refuse.

    JAX_PLATFORMS=cpu python tools/port_reference_glow.py [--port] [--n 64]
"""

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import fedm_tpu  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
from fedm_tpu.model.system import StepParams  # noqa: E402
from fedm_tpu.models.argon_synth import generate_argon_input  # noqa: E402
from fedm_tpu.models.glow import GlowConfig, GlowDischargeModel  # noqa: E402
from fedm_tpu.solvers.newton import NewtonConfig  # noqa: E402

# the glow50 protocol's Newton settings (tools/glow_run.py:129-132)
NEWTON = dict(rtol=1e-3, max_iter=20, linear_tol=1e-2, linear_maxiter=600,
              hi_residual=True)
AUX_KEYS = ("redE", "k", "mu", "D")
PROBE_PARAMS = (1e-12, 1e-12, 1e30)  # t, dt, dt_old (a BDF1 step)


def probe_state(u0: np.ndarray, coords: np.ndarray, cfg) -> np.ndarray:
    """The initial state with a cathode-fall potential and modulated
    log-densities (a state with fields and gradients everywhere)."""
    r, z = coords[:, 0], coords[:, 1]
    u = np.array(u0, dtype=np.float64)
    mod = 0.5 * np.sin(np.pi * z / cfg.gap_length) * np.cos(
        0.5 * np.pi * r / cfg.wall)
    u[:, :4] += mod[:, None]
    u[:, 4] = cfg.U_w * (1.0 - z / cfg.gap_length) ** 2
    return u


def column_norms(x) -> list:
    """Per-column 2-norms, summed in float64 whatever the array's type."""
    x = np.asarray(x, dtype=np.float64)
    x = x.reshape(len(x), -1)
    return [float(np.linalg.norm(x[:, k])) for k in range(x.shape[1])]


def jax_numbers(tree: Path, n: int) -> dict:
    model = GlowDischargeModel(GlowConfig(
        file_input=tree, nx=n, ny=n, dtype=jnp.float32,
        newton=NewtonConfig(**NEWTON, host_loop=True)))
    model.system.use_gather_scatter()
    s = model.initial_state()
    out = {"n": n, "n_dofs": int(model.space.n_dofs),
           "initial_state_norms": column_norms(s.u)}

    def residual(u, u_old, u_old1, params):
        aux = model._update_aux_jit(jnp.asarray(u_old))
        p = StepParams(*map(jnp.asarray, params))
        R = model.system._make_hi_residual(jnp.asarray(u_old),
                                           jnp.asarray(u_old1), aux, p)
        delta = (jnp.asarray(u) - jnp.asarray(u_old)).astype(jnp.float32)
        return column_norms(R(delta))

    out["initial_residual_norms"] = residual(
        s.u, s.u, s.u_old1, (s.t + s.dt, s.dt, s.dt_old))
    u = probe_state(np.asarray(s.u), model.space.dof_coords, model.cfg)
    aux = model._update_aux_jit(jnp.asarray(u))
    out["probe_aux_norms"] = {k: column_norms(aux[k]) for k in AUX_KEYS}
    out["probe_residual_norms"] = residual(u, u, u, PROBE_PARAMS)
    return out


def rel_gaps(got, ref) -> list:
    return [abs(a - b) / abs(b) if b else abs(a) for a, b in zip(got, ref)]


def port_gaps(tree: Path, n: int, ref: dict) -> dict:
    import torch

    from fedm_tpu_torch.model.system import StepParams as TParams
    from fedm_tpu_torch.models.glow import GlowConfig as TConfig
    from fedm_tpu_torch.models.glow import GlowDischargeModel as TModel
    from fedm_tpu_torch.solvers.newton import NewtonConfig as TNewton

    model = TModel(TConfig(file_input=tree, nx=n, ny=n, dtype=torch.float32,
                           newton=TNewton(**NEWTON)), device="cpu")
    model.system.use_gather_scatter()
    s = model.initial_state()
    out = {"initial_state": rel_gaps(column_norms(s.u),
                                     ref["initial_state_norms"])}

    def residual(u, u_old1, params, dtype):
        aux = model._update_aux(u)
        return column_norms(model.system.residual(
            u, u, u_old1, TParams(*params), dtype, aux=aux).double())

    first = (s.t + s.dt, s.dt, s.dt_old)
    for dtype, tag in ((torch.float64, ""), (torch.float32, "_f32")):
        out["initial_residual" + tag] = rel_gaps(
            residual(s.u, s.u_old1, first, dtype),
            ref["initial_residual_norms"])
    u = torch.as_tensor(probe_state(s.u.numpy(), model.space.dof_coords,
                                    model.cfg))
    aux = model._update_aux(u)
    out["probe_aux"] = {k: rel_gaps(column_norms(aux[k]),
                                    ref["probe_aux_norms"][k])
                        for k in AUX_KEYS}
    for dtype, tag in ((torch.float64, ""), (torch.float32, "_f32")):
        out["probe_residual" + tag] = rel_gaps(
            residual(u, u, PROBE_PARAMS, dtype), ref["probe_residual_norms"])
    out["mg_lmax"] = model.mg.lmax
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64, help="mesh cells per side")
    ap.add_argument("--port", action="store_true",
                    help="also print the port's CPU gaps and float32 "
                         "controls")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        tree = Path(tmp)
        generate_argon_input(tree)
        ref = jax_numbers(tree, args.n)
        print(json.dumps(ref), flush=True)
        if args.port:
            print(json.dumps({"port_cpu_gaps": port_gaps(tree, args.n, ref)}),
                  flush=True)


if __name__ == "__main__":
    main()
