"""Reference numbers for the PyTorch port's z-slab path (its
`tests/test_torch_slabs.py` pins them).

Runs, with the JAX package on the CPU over N virtual devices (default 8),
the miniature production configuration of
`tests/parallel/test_gspmd_production.py` (`_model`: float32 with the
float64 defect, host-loop Newton, structured assembly, the mg-zline
V-cycle with 3 levels, the density floor, the fixed-topology window)
under `CoupledSystem.use_gspmd`: the initial state, one advance, a window
move to (6.0e-3, 7.5e-3, 5e-5), a second advance; and prints one JSON
line, per advance: n_accepted, n_rejected, t, dt and the per-column
2-norms of u.

With --port it then runs the same protocol through the port on R gloo
ranks (default 2; `CoupledSystem.use_gspmd` over `parallel.ranks`) and
prints a second JSON line with the port's numbers and their gaps to the
JAX package's.

With --precond mg, or --cheb, it prints instead the numbers of the same
miniature with that Poisson-row solve (--precond mg: the point-smoothed
`GeometricMultigrid` the model builds for poisson_precond="mg"; --cheb:
the Chebyshev solve of `enable_elliptic_precond(2)`, installed before
`use_gspmd`), under `use_gspmd` on the N devices: the initial state's
column 2-norms, one step from it at STEP (t, dt, dt_old) = (5e-12, 5e-12,
1e30) (converged, Newton iterations, column 2-norms) and one advance (as
above); with --port also the port's, on R gloo ranks, and their gaps.
No window moves (the JAX package refuses a move under either).

With --shard it prints instead the round-1 route's numbers
(`CoupledSystem.shard` over the N devices) at
`tests/parallel/test_sharding.py`'s size (StreamerConfig(nx=12, ny=16),
float64, "mg"): from the initial state, the residual's column 2-norms,
the node blocks' 2-norm per entry (i, j) over the nodes at delta = 0, and
one step at (t, dt, dt_old) = (5e-12, 5e-12, 1e30): converged, Newton
iterations and the state's column 2-norms.

    JAX_PLATFORMS=cpu python tools/port_reference_gspmd.py [--devices 8]
        [--port] [--ranks 2] [--shard | --precond mg | --cheb]

The full-gap protocol (`bagheri_run --preset bagheri14-fullgap --precond
mg`, 546,795 unknowns) is not run here: a full-size configuration is for
the card, and `chip_smoke.py` holds its ranks to the port's own one-card
run of it.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

SPAN = 1.5e-3
DZ = 5e-5
Z0 = 8.5e-3
MOVE_TO = (6.0e-3, 6.0e-3 + SPAN, DZ)
NEWTON = dict(rtol=1e-3, max_iter=20, linear_tol=1e-4, linear_maxiter=200,
              accept_reduction=3e-2, host_loop=True, hi_residual=True)
CONFIG = dict(z_corridor=(Z0, Z0 + SPAN, DZ), r_corridor=(2e-3, 2e-4),
              z_tail_cells=(12, 12), mg_levels=3, poisson_precond="mg-zline",
              density_floor=1e13)


def record(st, u) -> dict:
    u = np.asarray(u, np.float64)
    return {"n_accepted": int(st.n_accepted),
            "n_rejected": int(st.n_rejected), "t": float(st.t),
            "dt": float(st.dt),
            "col_norms": [float(np.linalg.norm(u[:, k]))
                          for k in range(u.shape[1])]}


def jax_protocol(n_devices: int) -> list:
    import fedm_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fedm_tpu.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu.solvers.newton import NewtonConfig

    cfg = StreamerConfig(newton=NewtonConfig(**NEWTON), dtype=jnp.float32,
                         **CONFIG)
    m = StreamerModel(cfg)
    m.system.use_gather_scatter()
    m.system.enable_geom_mode()
    m.system.use_gspmd(Mesh(np.array(jax.devices()[:n_devices]),
                            ("space",)))
    st = m.initial_state()
    for f in ("u", "u_old", "u_old1"):
        setattr(st, f, m.system.place_state(getattr(st, f)))
    driver = m.make_driver()
    out = []
    st = driver.advance(st, {})
    out.append(record(st, st.u))
    st = m.move_window(MOVE_TO, st)
    st = driver.advance(st, {})
    out.append(record(st, st.u))
    return out


STEP = (5e-12, 5e-12, 1e30)


def jax_precond(n_devices: int, precond: str) -> dict:
    """The miniature under `use_gspmd` with the Poisson-row solve
    `precond` ("mg" or "cheb"): initial state, one step, one advance."""
    import fedm_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fedm_tpu.model.system import StepParams
    from fedm_tpu.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu.solvers.newton import NewtonConfig

    cfg = StreamerConfig(newton=NewtonConfig(**NEWTON), dtype=jnp.float32,
                         **precond_config(precond))
    m = StreamerModel(cfg)
    m.system.use_gather_scatter()
    if precond == "cheb":
        m.system.enable_elliptic_precond(2)
    m.system.use_gspmd(Mesh(np.array(jax.devices()[:n_devices]),
                            ("space",)))
    st = m.initial_state()
    for f in ("u", "u_old", "u_old1"):
        setattr(st, f, m.system.place_state(getattr(st, f)))
    u1, info = m.system.step(st.u, st.u, st.u, {},
                             StepParams(*(jnp.asarray(x) for x in STEP)))
    st = m.make_driver().advance(st, {})
    return precond_record(st.u_old, (info.converged, info.iters, u1), st)


def precond_config(precond: str) -> dict:
    """CONFIG with --precond mg's or --cheb's Poisson-row option ("cheb":
    the model's own mg-zline, replaced after the build)."""
    return {**CONFIG, "poisson_precond": "mg" if precond == "mg"
            else CONFIG["poisson_precond"]}


def precond_record(u0, step, st) -> dict:
    converged, iters, u1 = step
    return {"initial": record(st, u0)["col_norms"],
            "step": {"converged": bool(converged), "iters": int(iters),
                     "col_norms": record(st, u1)["col_norms"]},
            "advance": record(st, st.u)}


def port_precond(group, precond: str) -> dict:
    """`jax_precond` through the port on this rank's slab of `group`."""
    import torch

    from fedm_tpu_torch.model.system import StepParams
    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.solvers.newton import NewtonConfig

    cfg = StreamerConfig(newton=NewtonConfig(**NEWTON), dtype=torch.float32,
                         **precond_config(precond))
    m = StreamerModel(cfg, device="cpu")
    m.system.use_gather_scatter()
    if precond == "cheb":
        m.system.enable_elliptic_precond(2)
    m.system.use_gspmd(group)
    whole = m.system.gather_state
    st = m.initial_state()
    u1, info = m.system.step(st.u, st.u, st.u, {}, StepParams(*STEP))
    step = (info.converged, info.iters, whole(u1))
    u0 = whole(st.u)
    st = m.make_driver().advance(st, {})
    st.u = whole(st.u)
    return precond_record(u0, step, st)


SHARD_CFG = dict(nx=12, ny=16)
SHARD_PARAMS = (5e-12, 5e-12, 1e30)


def shard_record(F, B, u1, converged, iters) -> dict:
    F, B, u1 = (np.asarray(a, np.float64) for a in (F, B, u1))
    return {"F_norms": [float(np.linalg.norm(F[:, k]))
                        for k in range(F.shape[1])],
            "B_norms": [[float(np.linalg.norm(B[:, i, j]))
                         for j in range(B.shape[2])]
                        for i in range(B.shape[1])],
            "converged": bool(converged), "iters": int(iters),
            "u_norms": [float(np.linalg.norm(u1[:, k]))
                        for k in range(u1.shape[1])]}


def jax_shard(n_devices: int) -> dict:
    import fedm_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from fedm_tpu.model.system import StepParams
    from fedm_tpu.models.streamer import StreamerConfig, StreamerModel

    m = StreamerModel(StreamerConfig(**SHARD_CFG))
    st = m.initial_state()
    p = StepParams(*(jnp.asarray(x) for x in SHARD_PARAMS))
    zero = jnp.zeros_like(st.u)
    m.system.shard(Mesh(np.array(jax.devices()[:n_devices]), ("space",)),
                   "space")
    F = m.system.make_residual_fn(st.u, st.u, {}, p)(st.u)
    B = m.system._jacobian_blocks(zero, st.u, zero, {}, p)
    u1, info = m.system.step(st.u, st.u, st.u, {}, p)
    return shard_record(F, B, u1, info.converged, info.iters)


def port_model(device="cpu"):
    """The port's counterpart of `jax_protocol`'s model."""
    import torch

    from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel
    from fedm_tpu_torch.solvers.newton import NewtonConfig

    cfg = StreamerConfig(newton=NewtonConfig(**NEWTON), dtype=torch.float32,
                         **CONFIG)
    m = StreamerModel(cfg, device=device)
    m.system.use_gather_scatter()
    return m


def port_protocol(group) -> list:
    """`jax_protocol` through the port on this rank's slab of `group` (or
    on one process without a group)."""
    m = port_model()
    if group is not None:
        m.system.use_gspmd(group)
    st = m.initial_state()
    driver = m.make_driver()
    out = []
    st = driver.advance(st, {})
    out.append(record(st, m.system.gather_state(st.u)))
    st = m.move_window(MOVE_TO, st)
    st = driver.advance(st, {})
    out.append(record(st, m.system.gather_state(st.u)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--shard", action="store_true")
    ap.add_argument("--precond", choices=["mg"], default=None)
    ap.add_argument("--cheb", action="store_true")
    args = ap.parse_args()
    precond = "cheb" if args.cheb else args.precond
    if precond is not None:
        ref = jax_precond(args.devices, precond)
        print(json.dumps({"devices": args.devices, precond: ref}),
              flush=True)
        if args.port:
            from fedm_tpu_torch.parallel import ranks

            got = ranks.launch(port_precond, args.ranks, "cpu",
                               (precond,))[0]
            gaps = {"initial": max(abs(a - b) / abs(b) for a, b in
                                   zip(got["initial"], ref["initial"])),
                    "step": max(abs(a - b) / abs(b) for a, b in
                                zip(got["step"]["col_norms"],
                                    ref["step"]["col_norms"])),
                    "advance": {k: (max(abs(a - b) / abs(b) for a, b in
                                        zip(got["advance"][k],
                                            ref["advance"][k]))
                                    if k == "col_norms" else
                                    abs(got["advance"][k] - ref["advance"][k])
                                    / abs(ref["advance"][k])
                                    if k in ("t", "dt") else
                                    got["advance"][k] - ref["advance"][k])
                                for k in ref["advance"]}}
            print(json.dumps({"ranks": args.ranks, precond: got,
                              "gaps": gaps}), flush=True)
        return
    if args.shard:
        print(json.dumps({"devices": args.devices,
                          "shard": jax_shard(args.devices)}), flush=True)
        return
    ref = jax_protocol(args.devices)
    print(json.dumps({"devices": args.devices, "advances": ref}), flush=True)
    if args.port:
        from fedm_tpu_torch.parallel import ranks

        got = ranks.launch(port_protocol, args.ranks, "cpu")[0]
        gaps = [{k: (max(abs(a - b) / abs(b) for a, b in
                         zip(g[k], r[k])) if k == "col_norms"
                     else abs(g[k] - r[k]) / abs(r[k]) if k in ("t", "dt")
                     else g[k] - r[k])
                 for k in r} for g, r in zip(got, ref)]
        print(json.dumps({"ranks": args.ranks, "advances": got,
                          "gaps": gaps}), flush=True)


if __name__ == "__main__":
    main()
