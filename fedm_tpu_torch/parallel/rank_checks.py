"""Rank workers that hold the ranked code to the stacked one: each runs
on every rank of a `ranks.launch` (or a one-rank group), builds its
inputs itself from a seed, and returns its rank's rows and numbers on the
host, for the caller to put together and compare with one process's.
They live in the package, so that the spawned ranks import neither a
test module nor JAX.

    halo(group, spec)        the halo fill and reduce on seeded payloads
    reductions(group, spec)  `_dot`, `_norm`, their batched forms, finite
    dd(group, spec)          a distributed model's residual, node blocks
                             and one step, with its Newton/Krylov log
    sweep(group, spec)       a `BatchedSweep` over the ranks
    skip_collective(group)   rank 0 reduces, the others do not
    stall(group, seconds)    every rank sleeps (a run past its limit)
    several(group, jobs)     the workers named in `jobs`, in order, in one
                             launch
"""

from __future__ import annotations

import dataclasses
import time
from unittest import mock

import numpy as np
import torch

from ..devtime import card_of, on_card
from .ranks import Group, part_devices


def _streamer(spec: dict, device):
    from ..models.streamer import StreamerConfig, StreamerModel

    return StreamerModel(StreamerConfig(**spec.get("cfg", {})),
                         device=device)


def halo(group: Group, spec: dict) -> dict:
    """The streamer's DD (spec: cfg, n_parts, seed) on this rank's parts:
    `_halo_fill` of this rank's rows of a seeded [N*n_own_max, 3] payload,
    and `_halo_reduce` of its rows of a seeded [N*n_ext, 3] one."""
    m = _streamer(spec, group.device)
    d = m.distribute(part_devices(spec["n_parts"], group), group)
    rng = np.random.default_rng(spec.get("seed", 0))
    x = rng.standard_normal((d.n_dofs_dist, 3))
    r = rng.standard_normal((d.n_parts * d.n_ext, 3))
    ext = slice(d.part0 * d.n_ext, (d.part0 + d.n_local) * d.n_ext)
    put = lambda a: torch.as_tensor(a, device=group.device)  # noqa: E731
    return {"rank": group.rank, "card": card_of(group.device),
            "fill": d._halo_fill(put(x[d.row0:d.row0 + d.n_rows])).cpu(),
            "reduce": d._halo_reduce(put(r[ext])).cpu()}


def _split(a: np.ndarray, group: Group, axis: int = 0):
    """This rank's block of `a` along `axis` (equal blocks)."""
    n = a.shape[axis] // group.size
    return np.take(a, np.arange(group.rank * n, (group.rank + 1) * n),
                   axis=axis)


def reductions(group: Group, spec: dict) -> dict:
    """`_dot`, `_norm` and `finite` of seeded vectors (spec: n rows, B
    members, seed) whose rows are split over the ranks, and `dot_b`,
    `norm_b` and `finite_b` of members split over them as the sweep splits
    them (each member on one rank, the results gathered): every rank's
    values, which must be one process's."""
    from ..solvers.linear import _dot, _norm, dot_b, finite, finite_b, norm_b

    rng = np.random.default_rng(spec.get("seed", 0))
    n, B = spec["n"], spec.get("B", 4)
    scale = 10.0 ** rng.integers(-30, 30, size=(n, 1))
    a = rng.standard_normal((n, 3)) * scale
    b = rng.standard_normal((n, 3))
    ab = rng.standard_normal((B, n, 2)) * scale[None]
    bb = rng.standard_normal((B, n, 2))
    put = lambda x: torch.as_tensor(x, device=group.device)  # noqa: E731
    la, lb = put(_split(a, group)), put(_split(b, group))
    lab, lbb = put(_split(ab, group)), put(_split(bb, group))
    nan = la.clone()
    if group.rank == group.size - 1:
        nan[-1, 0] = float("nan")
    inf_b = ab.copy()
    inf_b[1, 0, 0] = np.inf
    gather = lambda x: group.all_gather_rows(x).cpu().numpy()  # noqa: E731
    return {"dot": float(_dot(la, lb, group)),
            "norm": float(_norm(la, group)),
            "dot_b": gather(dot_b(lab, lbb)),
            "norm_b": gather(norm_b(lab)),
            "finite": (finite(la, group), finite(nan, group)),
            "finite_b": gather(finite_b(put(_split(inf_b, group))).to(
                torch.int64)).astype(bool)}


def _counting(counts: dict, log: list, name: str, fn):
    """`fn`, adding to counts[name] its Krylov iterations (the third item
    it returns), or one per Newton iteration, and logging its numbers."""
    def run(*args, **kw):
        out = fn(*args, **kw)
        if name == "newton_iteration":
            counts[name] = counts.get(name, 0) + 1
            log.append((name, float(out[1]), float(out[2]), bool(out[3])))
        else:
            counts[name] = counts.get(name, 0) + int(out[2])
            log.append((name, int(out[2]), float(out[1])))
        return out

    return run


def _model(spec: dict, device):
    if spec["model"] == "streamer":
        return _streamer(spec, device)
    from pathlib import Path

    from ..examples import extended_scheme

    args = extended_scheme.parse_args(["--device", str(device),
                                       *spec.get("argv", [])])
    return extended_scheme.build_model(args, Path(spec["tree"]),
                                       spec["tree_name"])


def _dropping_remote(d):
    """`d._roll` with the rows that the reverse exchange receives from
    other ranks dropped (the control: no cross-rank reverse exchange)."""
    roll = d._roll

    def run(payload, shift, move):
        out = roll(payload, shift, move)
        if shift < 0 and move is not None:
            for j in move[2].values():
                out[j] = 0.0
        return out

    return run


def _step(d, model, s, p, device):
    """One step of the distributed system from the state `s`, with its
    Newton/Krylov counts and log and K1's launches (counts set to 0 just
    before, read just after)."""
    from ..ops import ell_scatter as k1
    from ..solvers import newton

    counts, log = {}, []
    patches = {name: _counting(counts, log, name, getattr(newton, name))
               for name in ("newton_iteration", "bicgstab", "gmres")}
    with mock.patch.multiple(newton, **patches):
        k1.LAUNCHES.clear()

        def go():
            aux = (model._update_aux(s.u) if spec_is_generic(model) else {})
            return d.step(s.u, s.u, s.u_old1, aux, p)

        (u1, info), secs = on_card(go, device)
        launches = dict(k1.LAUNCHES)
    return {"u": u1.cpu(), "converged": bool(info.converged),
            "iters": int(info.iters), "res_norm": float(info.res_norm),
            "res0_norm": float(info.res0_norm),
            "newton_iterations": counts.get("newton_iteration", 0),
            "bicgstab_iterations": counts.get("bicgstab", 0),
            "gmres_iterations": counts.get("gmres", 0), "log": log,
            "s": secs,
            "launches": {" ".join(map(str, k)): n
                         for k, n in launches.items()}}


def spec_is_generic(model) -> bool:
    return hasattr(model, "n_species")


def dd(group: Group, spec: dict) -> dict:
    """A distributed model on this rank's parts (spec: model "streamer"
    with cfg, or "extended" with tree, tree_name and argv; n_parts):
    its layout, the float64 residual and the node blocks at the initial
    state (this rank's rows), and, as spec asks, one step (`step`), after
    `enable_distributed_elliptic(eq)` (`elliptic`), the residual and the
    step without the cross-rank reverse exchange (`control`), and on a
    card K1 against its plain version at this rank's cell table
    (`k1`)."""
    from ..model.system import StepParams

    dev = group.device
    model = _model(spec, dev)
    d = model.distribute(part_devices(spec["n_parts"], group), group)
    s = model.initial_state()
    aux = model._update_aux(s.u) if spec_is_generic(model) else {}
    p = StepParams(s.t + s.dt, s.dt, s.dt_old)
    F = d.residual(s.u, s.u, s.u_old1, p, aux=aux)
    B = d.operators(s.u, s.u_old1, p, aux=aux).jacobian_blocks(
        torch.zeros_like(s.u))
    out = {"rank": group.rank, "card": card_of(dev), "row0": d.row0,
           "n_rows": d.n_rows, "n_own_max": d.n_own_max,
           "n_ghost_max": d.n_ghost_max, "shifts": list(d._shifts),
           "F": F.cpu(), "B": B.cpu(), "u0": s.u.cpu(),
           "aux": {k: v.cpu() for k, v in aux.items()
                   if isinstance(v, torch.Tensor) and v.dim() >= 1
                   and v.shape[0] == d.n_rows}}
    del B
    if spec.get("k1") and dev.type == "cuda":
        out["k1"] = _k1_at(d, dev)
    if spec.get("elliptic") is not None:
        d.enable_distributed_elliptic(spec["elliptic"])
    if spec.get("step"):
        out["step"] = _step(d, model, s, p, dev)
    if spec.get("control"):
        with mock.patch.object(d, "_roll", _dropping_remote(d)):
            out["control_F"] = d.residual(s.u, s.u, s.u_old1, p,
                                          aux=aux).cpu()
            if spec.get("step"):
                out["control_step"] = _step(d, model, s, p, dev)
    return out


def _k1_at(d, dev) -> dict:
    """K1's compact form against its plain version at this rank's stacked
    cell table, at the residual's width (C = n_eq), float64."""
    from ..ops import ell_scatter as k1

    b = d._batches[0][0]
    gen = torch.Generator(device=dev).manual_seed(12)
    C = d.n_eq
    flat = torch.randn((b.dofs.numel(), C), generator=gen, device=dev,
                       dtype=torch.float64)
    out0 = torch.randn((d.n_local * d.n_ext, C), generator=gen, device=dev,
                       dtype=torch.float64)
    before = k1.launch_count("ell_scatter_add_")
    got = k1.ell_scatter_add_(out0.clone(), flat, b.scatter_idx,
                              b.scatter_rows)
    launched = k1.launch_count("ell_scatter_add_") - before
    ref = k1.ell_scatter_add_ref(out0.clone(), flat, b.scatter_idx,
                                 b.scatter_rows)
    return {"case": f"rank cell table C={C} float64",
            "n_rows": int(b.scatter_idx.shape[0]),
            "max_val": int(b.scatter_idx.shape[1]),
            "max_abs_err": float((got - ref).abs().max()),
            "scale": float(ref.abs().max()), "launched": launched,
            "device": str(got.device)}


def sweep(group: Group, spec: dict) -> dict:
    """A `BatchedSweep` over the group (spec: cfg of the StreamerConfig,
    amps, attempts, monitor; `start`, a SweepState's arrays, in place of
    the members' own initial states): every member's initial state, then
    `attempts` lockstep attempts; the whole SweepState's record after
    each (every rank holds all of it), the final states, each attempt's
    wall time on this rank's card and K1's launches."""
    from ..models.streamer import StreamerConfig, StreamerModel
    from ..ops import ell_scatter as k1
    from .sweep import BatchedSweep

    dev = group.device
    cfg = StreamerConfig(**spec.get("cfg", {}))
    model = StreamerModel(cfg, device=dev)
    amps = spec["amps"]
    sw = BatchedSweep(model.system, monitor_idx=spec.get("monitor", 1),
                      ttol=cfg.ttol, dt_min=cfg.dt_min, dt_max=cfg.dt_max,
                      batch_sharding=part_devices(len(amps), group),
                      group=group)
    mine = sw._members(len(amps))
    if "start" in spec:
        from ..convert import sweep_state_from_arrays

        st = sweep_state_from_arrays(spec["start"], device=dev)
    else:
        states = [StreamerModel(dataclasses.replace(cfg, seed_amplitude=a),
                                device=dev).initial_state()
                  if mine.start <= i < mine.stop else None
                  for i, a in enumerate(amps)]
        st = sw.from_states(states)
    initial = record(st)
    records, secs = [], []
    k1.LAUNCHES.clear()
    for _ in range(spec.get("attempts", 3)):
        st, t = on_card(lambda st=st: sw.attempt(st, {}), dev)
        secs.append(t)
        records.append(record(st))
    return {"rank": group.rank, "card": card_of(dev), "members": mine,
            "initial": initial, "records": records, "u": st.u.cpu(),
            "attempt_s": secs,
            "launches": sum(k1.LAUNCHES.values())}


def record(st) -> dict:
    """A SweepState's numbers: the counts, t, dt, max_error and the
    members' per-column 2-norms."""
    return {"n_accepted": st.n_accepted.tolist(),
            "n_rejected": st.n_rejected.tolist(), "t": st.t.tolist(),
            "dt": st.dt.tolist(), "max_error": st.max_error.tolist(),
            "u_norms": torch.linalg.vector_norm(
                st.u.double(), dim=1).tolist()}


def skip_collective(group: Group) -> float:
    """Rank 0 all-reduces; every other rank returns without: the launch
    must fail (the collective times out or loses its peers)."""
    if group.rank == 0:
        return float(group.all_reduce(torch.ones(1, device=group.device)))
    return 0.0


def stall(group: Group, seconds: float) -> None:
    """Every rank sleeps `seconds`: a launch with a shorter time limit
    must kill its ranks and raise."""
    time.sleep(seconds)


def several(group: Group, jobs: list) -> dict:
    """Run the workers of `jobs`, (key, worker name, spec) in order, on
    one launch's ranks: {key: that worker's result}."""
    return {key: globals()[name](group, spec) for key, name, spec in jobs}
