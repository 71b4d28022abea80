"""Reference numbers for the PyTorch port's `8 extended` smoke phase.

Builds, with the JAX package on the CPU (8 virtual devices), the extended
reaction scheme of `examples/extended_scheme.py` at its defaults: the
18-species synthetic argon tree (`generate_argon_n_input`, generated into
a temporary directory), the 19-equation `PlasmaModel` on a crossed 32 x 64
mesh, float64, `mg_levels=0`, `quad_degree=2`, and prints one JSON line:

  partition  the partition of the dual graph into 8 parts by the native
             partitioner (checksum sum_i (i+1)*part[i], part sizes) and
             the JAX `DistributedSystem`'s n_own_max, n_ghost_max and
             ring shifts (its host tables only: no shard_map is compiled);
  model      species, equations, dofs, unknowns, reactions;
  initial    per-column 2-norms of the initial state, and the
             per-equation 2-norms of the float64 residual of the first
             attempted step (delta = 0, t = dt = dt_init, dt_old = 1e30,
             with the coefficients `_update_aux` gives there) and of the
             node blocks' rows B[:, i, :] at that point;
  step       the single-device `CoupledSystem.step` from there: converged,
             Newton and BiCGStab iterations (counted by host callbacks)
             and the per-column 2-norms of the new state;
  spread     the [min, max] of those counts over the unperturbed step and
             20 steps from the state scaled by (1 + 1e-12 * seeded noise):
             BiCGStab's count over ~230 iterations moves with rounding;
  example    `examples/extended_scheme.py --devices 8 --steps 1` run as a
             process on 8 virtual devices: its printed lines.

With --port it then builds the same with the port on the CPU and prints a
second JSON line: its gaps to those numbers, the distributed (8 parts)
residual's and node blocks' gaps to the undistributed ones, and the
controls the smoke phase's tolerances must refuse (the distributed
residual with the reverse halo exchange skipped, and the residual in
float32).

    JAX_PLATFORMS=cpu python tools/port_reference_extended.py [--port]
        [--nx 32 --ny 64] [--no-example]
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

import fedm_tpu  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from fedm_tpu.model.system import StepParams  # noqa: E402
from fedm_tpu.models.argon_synth import generate_argon_n_input  # noqa: E402
from fedm_tpu.models.generic import PlasmaConfig, PlasmaModel  # noqa: E402

N_PARTS = 8
SPREAD_EPS, SPREAD_SEEDS = 1e-12, 20
_JAX_COUNTS = {}


def column_norms(x) -> list:
    x = np.asarray(x, dtype=np.float64)
    x = x.reshape(len(x), -1)
    return [float(np.linalg.norm(x[:, k])) for k in range(x.shape[1])]


def row_norms(B) -> list:
    """Frobenius norms of the node blocks' rows B[:, i, :]."""
    B = np.asarray(B, dtype=np.float64)
    return [float(np.linalg.norm(B[:, i, :])) for i in range(B.shape[1])]


def checksum(part) -> int:
    part = np.asarray(part, dtype=np.int64)
    return int(np.sum((np.arange(len(part)) + 1) * part))


def _count_jax_iterations() -> None:
    from fedm_tpu.solvers import newton

    def counting(name, fn):
        def bump(k):
            _JAX_COUNTS[name] = _JAX_COUNTS.get(name, 0) + int(k)

        def run(*args, **kw):
            out = fn(*args, **kw)
            jax.debug.callback(bump, 1 if name == "newton_iteration"
                               else out[2])
            return out

        return run

    for name in ("newton_iteration", "bicgstab", "gmres"):
        setattr(newton, name, counting(name, getattr(newton, name)))


def jax_model(base: Path, name: str, nx: int, ny: int):
    return PlasmaModel(PlasmaConfig(model=name, file_input=base, nx=nx,
                                    ny=ny, mg_levels=0, quad_degree=2))


def first_params(s):
    return (s.t + s.dt, s.dt, s.dt_old)


def jax_numbers(base: Path, name: str, nx: int, ny: int) -> dict:
    from jax.sharding import Mesh

    from fedm_tpu.mesh.reorder import cell_adjacency_csr
    from fedm_tpu.native import native_available, partition_graph

    out = {}
    m = jax_model(base, name, nx, ny)
    assert native_available()
    part = partition_graph(*cell_adjacency_csr(m.mesh), N_PARTS)
    dm = jax_model(base, name, nx, ny)
    d = dm.distribute(Mesh(np.array(jax.devices()[:N_PARTS]), ("space",)))
    out["partition"] = {
        "n_parts": N_PARTS, "n_cells": int(m.mesh.n_cells),
        "part_checksum": checksum(part),
        "part_sizes": np.bincount(part, minlength=N_PARTS).tolist(),
        "n_own_max": int(d.n_own_max), "n_ghost_max": int(d.n_ghost_max),
        "shifts": sorted({(dst - src) % N_PARTS for pf, _ in d._shifts
                          for src, dst in pf})}
    out["model"] = {"n_species": m.n_species, "n_eq": m.n_eq,
                    "n_dofs": int(m.space.n_dofs),
                    "unknowns": int(m.space.n_dofs * m.n_eq),
                    "n_reactions": int(m.P_mat.shape[0]),
                    "species": list(m.species)}

    s = m.initial_state()
    aux = m._update_aux_jit(s.u)
    params = StepParams(*(jnp.asarray(x) for x in first_params(s)))
    F = m.system.residual(s.u, s.u, s.u_old1, aux, params)
    zero = jnp.zeros_like(s.u)
    B = m.system._jacobian_blocks(zero, s.u, s.u - s.u_old1, aux, params)
    out["initial"] = {"state_norms": column_norms(s.u),
                      "residual_norms": column_norms(F),
                      "block_row_norms": row_norms(B),
                      "params": list(first_params(s))}

    _count_jax_iterations()
    _JAX_COUNTS.clear()
    t0 = time.perf_counter()
    u1, info = m.system.step(s.u, s.u, s.u_old1, aux, params)
    jax.block_until_ready(u1)
    jax.effects_barrier()
    out["step"] = {"converged": bool(info.converged),
                   "newton_iterations": _JAX_COUNTS.get("newton_iteration",
                                                        0),
                   "bicgstab_iterations": _JAX_COUNTS.get("bicgstab", 0),
                   "gmres_iterations": _JAX_COUNTS.get("gmres", 0),
                   "state_norms": column_norms(u1),
                   "host_s": time.perf_counter() - t0}
    # the counts' own spread: the same step from the state scaled by
    # (1 + 1e-12 * seeded noise), the coefficients updated there
    newton_n, krylov_n = [out["step"]["newton_iterations"]], [
        out["step"]["bicgstab_iterations"]]
    for seed in range(SPREAD_SEEDS):
        noise = np.random.default_rng(seed).standard_normal(s.u.shape)
        u = jnp.asarray(np.asarray(s.u) * (1 + SPREAD_EPS * noise))
        _JAX_COUNTS.clear()
        u1, _ = m.system.step(u, u, s.u_old1, m._update_aux_jit(u), params)
        jax.block_until_ready(u1)
        jax.effects_barrier()
        newton_n.append(_JAX_COUNTS["newton_iteration"])
        krylov_n.append(_JAX_COUNTS.get("bicgstab", 0))
    out["spread"] = {"eps": SPREAD_EPS, "seeds": SPREAD_SEEDS,
                     "newton_iterations": [min(newton_n), max(newton_n)],
                     "bicgstab_iterations": [min(krylov_n), max(krylov_n)],
                     "bicgstab_all": krylov_n}
    return out


EXAMPLE_LINE = re.compile(
    r"(\d+) accepted steps to t=(\S+) \((\d+) rejected\), \S+ s/step, "
    r"ne_max=(\S+) m\^-3, eps_mean=(\S+) eV, finite: (\w+)")


def parse_example(stdout: str) -> dict:
    """The numbers of an extended-scheme example's printed lines."""
    out = {"lines": stdout.strip().splitlines()}
    for line in out["lines"]:
        mt = EXAMPLE_LINE.search(line)
        if mt:
            out.update(accepted=int(mt[1]), t=float(mt[2]),
                       rejected=int(mt[3]), ne_max=float(mt[4]),
                       eps_mean=float(mt[5]), finite=mt[6] == "True")
        mt = re.search(r"(\d+) own \+ (\d+) ghost rows/dev", line)
        if mt:
            out.update(n_own_max=int(mt[1]), n_ghost_max=int(mt[2]))
    return out


def jax_example(nx: int, ny: int) -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "extended_scheme.py"),
         "--devices", str(N_PARTS), "--steps", "1", "--nx", str(nx),
         "--ny", str(ny)], capture_output=True, text=True, check=True,
        env=dict(os.environ, XLA_FLAGS=os.environ["XLA_FLAGS"]))
    out = parse_example(proc.stdout)
    out["host_s"] = time.perf_counter() - t0
    return out


def _rel(got, ref) -> list:
    return [abs(a - b) / abs(b) if b else abs(a) for a, b in zip(got, ref)]


def port_numbers(base: Path, name: str, nx: int, ny: int, ref: dict) -> dict:
    import torch

    from fedm_tpu_torch.model.system import StepParams as TParams
    from fedm_tpu_torch.models.generic import PlasmaConfig as TC
    from fedm_tpu_torch.models.generic import PlasmaModel as TM

    def model():
        return TM(TC(model=name, file_input=base, nx=nx, ny=ny,
                     mg_levels=0, quad_degree=2), device="cpu")

    def norms(x):
        return column_norms(x.detach().cpu().numpy())

    out = {}
    m, md = model(), model()
    d = md.distribute(["cpu"] * N_PARTS)
    out["partition_equal"] = (
        checksum(d.cell_part) == ref["partition"]["part_checksum"]
        and d.n_own_max == ref["partition"]["n_own_max"]
        and d.n_ghost_max == ref["partition"]["n_ghost_max"]
        and d._shifts == ref["partition"]["shifts"])
    s, sd = m.initial_state(), md.initial_state()
    aux, auxd = m._update_aux(s.u), md._update_aux(sd.u)
    p = TParams(*ref["initial"]["params"])
    F = m.system.residual(s.u, s.u, s.u_old1, p, aux=aux)
    Fd = md.system.residual(sd.u, sd.u, sd.u_old1, p, aux=auxd)
    z, zd = torch.zeros_like(s.u), torch.zeros_like(sd.u)
    B = m.system.operators(s.u, s.u_old1, p, aux=aux).jacobian_blocks(z)
    Bd = md.system.operators(sd.u, sd.u_old1, p,
                             aux=auxd).jacobian_blocks(zd)
    r = ref["initial"]
    out["state_rel"] = _rel(norms(s.u), r["state_norms"])
    out["residual_rel"] = _rel(norms(F), r["residual_norms"])
    out["dist_residual_rel"] = _rel(column_norms(d.from_dist(Fd)),
                                    r["residual_norms"])
    out["blocks_rel"] = _rel(row_norms(B.numpy()), r["block_row_norms"])
    out["dist_blocks_rel"] = _rel(row_norms(d.from_dist(Bd)),
                                  r["block_row_norms"])
    Fn, Fdn = F.numpy(), d.from_dist(Fd)
    out["dist_vs_undist_residual_max_rel"] = float(
        np.abs(Fdn - Fn).max() / np.abs(Fn).max())
    phantom = np.setdiff1d(np.arange(d.n_dofs_dist), d._slot_of)
    out["phantom_rows_max_abs"] = float(Fd[phantom].abs().max()) \
        if len(phantom) else 0.0
    # controls: the reverse exchange skipped, and the residual in float32
    reduce = d._halo_reduce
    d._halo_reduce = lambda r_ext: r_ext.reshape(
        (d.n_parts, d.n_ext) + tuple(r_ext.shape[1:]))[
        :, :d.n_own_max].reshape((d.n_dofs_dist,) + tuple(r_ext.shape[1:]))
    Fc = md.system.residual(sd.u, sd.u, sd.u_old1, p, aux=auxd)
    d._halo_reduce = reduce
    out["control_no_reverse_exchange_rel"] = _rel(
        column_norms(d.from_dist(Fc)), r["residual_norms"])
    out["control_f32_rel"] = _rel(norms(m.system.residual(
        s.u, s.u, s.u_old1, p, torch.float32, aux=aux)), r["residual_norms"])
    from fedm_tpu_torch.solvers import newton

    counts = {}
    saved = {n: getattr(newton, n) for n in ("newton_iteration", "bicgstab")}

    def counting(name, fn):
        def run(*a, **kw):
            res = fn(*a, **kw)
            counts[name] = counts.get(name, 0) + (
                1 if name == "newton_iteration" else int(res[2]))
            return res
        return run

    for n, fn in saved.items():
        setattr(newton, n, counting(n, fn))
    try:
        for key, model, st, a in (("undistributed", m, s, aux),
                                  ("distributed", md, sd, auxd)):
            counts.clear()
            u1, info = model.system.step(st.u, st.u, st.u_old1, a, p)
            u1 = d.from_dist(u1) if key == "distributed" else u1.numpy()
            out[f"{key}_step"] = {
                "converged": bool(info.converged), **counts,
                "state_rel": _rel(column_norms(u1),
                                  ref["step"]["state_norms"])}
    finally:
        for n, fn in saved.items():
            setattr(newton, n, fn)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--no-example", action="store_true",
                    help="skip the JAX example run")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        root = generate_argon_n_input(Path(tmp), n_excited=13)
        ref = jax_numbers(Path(tmp), root.name, args.nx, args.ny)
        if not args.no_example:
            ref["example"] = jax_example(args.nx, args.ny)
        print(json.dumps(ref), flush=True)
        if args.port:
            print(json.dumps(port_numbers(Path(tmp), root.name, args.nx,
                                          args.ny, ref)), flush=True)


if __name__ == "__main__":
    main()
