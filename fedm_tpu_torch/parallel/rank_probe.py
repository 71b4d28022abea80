"""Where one rank's residual and node blocks leave the stacked run's bits.

A rank of the domain decomposition holds L = N/R of the N parts and runs
the one-card code on them; its residual and node blocks should equal the
stacked run's rows bit for bit. This probe runs both in one process on
one device, with no process group: the stacked system (N parts), and rank
`--rank` of R (`DistributedSystem` with a group object that only names
the rank, so no collective runs). The rank is fed the stacked run's
halo-filled inputs, and its reverse exchange replays the stacked run's
payloads, so every difference it finds is made on the rank's own rows:

1. the gathered inputs of each element batch (its context and state);
2. each aten op of each batch's element kernel, in order (the first op
   whose output differs while its predecessors agreed names the term);
3. each batch's kernel output and the element tangents of the node
   blocks;
4. the summed scatter (K1) before the halo reduction;
5. the halo reduction itself (the stacked run's payloads replayed);
6. the residual and the node blocks at the end.

    python -m fedm_tpu_torch.parallel.rank_probe            # on the card
    python -m fedm_tpu_torch.parallel.rank_probe --grad-by-terms
    python -m fedm_tpu_torch.parallel.rank_probe --device cpu --nx 8 \\
        --ny 8 --parts 4 --ranks 2

At the extended scheme's defaults (18 species, 32 x 64, 8 parts, R = 4).
Prints one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class _Named:
    """A group that only names the rank: the probe calls no collective."""

    def __init__(self, rank: int, size: int, device):
        self.rank, self.size = rank, size
        self.device = torch.device(device)

    def all_reduce(self, t, op="sum"):
        return t

    def check_same(self, value, what):
        pass


class _OpLog(TorchDispatchMode):
    """Every aten op's name, input shapes and (cloned) tensor outputs."""

    def __init__(self, log: list):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        shapes = [tuple(a.shape) for a in args
                  if isinstance(a, torch.Tensor)]
        self.log.append((str(func), shapes,
                         [o.detach().clone() for o in outs
                          if isinstance(o, torch.Tensor)]))
        return out


def _rows_of(full: torch.Tensor, part: torch.Tensor, k: int, R: int):
    """The slice of `full` that corresponds to rank k's `part`: along the
    one axis where `full` is R times longer (None if there is none)."""
    if full.shape == part.shape:
        return full
    if full.dim() != part.dim():
        return None
    axes = [i for i in range(full.dim()) if full.shape[i] != part.shape[i]]
    if len(axes) != 1 or full.shape[axes[0]] != R * part.shape[axes[0]]:
        return None
    n = part.shape[axes[0]]
    return full.narrow(axes[0], k * n, n)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (NaNs where the other has NaNs)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if torch.equal(a, b):
        return True
    return (a.is_floating_point() and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def _gap(full: torch.Tensor, part: torch.Tensor, k: int, R: int) -> dict:
    ref = _rows_of(full, part, k, R)
    if ref is None:
        return {"comparable": False, "full": list(full.shape),
                "part": list(part.shape)}
    out = {"equal": _same(ref, part), "shape": list(part.shape)}
    if not out["equal"] and part.is_floating_point():
        d = (ref - part).abs()
        out.update(max_abs_diff=float(d.max()),
                   max_abs=float(ref.abs().max()),
                   n_diff=int((ref != part).sum()))
    return out


def _first_op_gap(log_full: list, log_part: list, k: int, R: int) -> dict:
    """The first op (in order, names matching) whose comparable output
    differs."""
    n = 0
    for i, ((f, sf, of), (g, sg, og)) in enumerate(zip(log_full, log_part)):
        if f != g:
            return {"diverged_at": i, "full_op": f, "part_op": g}
        for o8, oR in zip(of, og):
            gap = _gap(o8, oR, k, R)
            if gap.get("comparable", True):
                n += 1
            if gap.get("equal") is False:
                return {"first_differing_op": i, "op": f,
                        "input_shapes_full": sf, "input_shapes_part": sg,
                        "gap": gap, "ops_compared": n,
                        "previous_ops": [x[0] for x in
                                         log_full[max(0, i - 6):i]]}
    return {"ops": len(log_full), "outputs_compared": n, "all_equal": True}


def _models(device, nx, ny, species):
    """Two extended-scheme models on the generated tree (each distributed
    once below)."""
    import shutil

    from ..examples import extended_scheme
    from ..models.argon_synth import generate_argon_n_input

    tmp = tempfile.mkdtemp(prefix="rank_probe_")
    try:
        root = generate_argon_n_input(Path(tmp), n_excited=species - 5)
        args = extended_scheme.parse_args(
            ["--device", str(device), "--nx", str(nx), "--ny", str(ny)])
        return lambda: extended_scheme.build_model(args, Path(tmp),
                                                   root.name), tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _rank(build, d8, s8, aux8, p, dev, n_ranks: int, k: int) -> dict:
    """Rank k of `n_ranks` against the stacked system `d8` (module
    docstring, steps 1-6)."""
    from .dd import DistributedSystem

    N, R = d8.n_parts, n_ranks
    L = N // R
    devices = [dev if q == k else
               (torch.device("cuda", q) if dev.type == "cuda" else dev)
               for q in range(R) for _ in range(L)]
    mR = build()
    dR = DistributedSystem(mR.system, devices, _Named(k, R, dev))
    rows = slice(dR.row0, dR.row0 + dR.n_rows)
    ext = slice(k * L * d8.n_ext, (k + 1) * L * d8.n_ext)
    uR, u1R = s8.u[rows], s8.u_old1[rows]
    auxR = {key: (v[rows] if isinstance(v, torch.Tensor) and v.dim() >= 1
                  and v.shape[0] == d8.n_dofs_dist else v)
            for key, v in aux8.items()}

    # the stacked run's fills, reverse payloads and reductions, recorded;
    # the rank reads its rows of them
    fills, payloads, red8, redR = [], [], [], []
    fill8, roll8, reduce8 = d8._halo_fill, d8._roll, d8._halo_reduce

    def fill_rec(x):
        y = fill8(x)
        fills.append((x, y))
        return y

    def roll_rec(payload, d, move):
        if d < 0:
            payloads.append((d, payload))
        return roll8(payload, d, move)

    def reduce_rec(r):
        y = reduce8(r)
        red8.append((r, y))
        return y

    def fill_replay(x):
        for full, filled in fills:
            if (full.shape[1:] == x.shape[1:] and full.dtype == x.dtype
                    and torch.equal(full[rows], x)):
                return filled[ext]
        raise RuntimeError("no stacked fill matches this rank's input")

    def reduce_replay(r):
        redR.append(r)
        return red8[len(redR) - 1][1][rows]

    d8._halo_fill, d8._roll, d8._halo_reduce = fill_rec, roll_rec, reduce_rec
    dR._halo_fill, dR._halo_reduce = fill_replay, reduce_replay
    out = {"rank": k, "parts": [k * L, (k + 1) * L]}
    try:
        ops8 = d8.operators(s8.u, s8.u_old1, p, aux=aux8)
        opsR = dR.operators(uR, u1R, p, aux=auxR)
        # 1: the gathered inputs
        out["ctx"] = {}
        for bi, (c8, cR) in enumerate(zip(ops8.ctxs, opsR.ctxs)):
            for key, a in c8.items():
                if isinstance(a, torch.Tensor):
                    g = _gap(a, cR[key], k, R)
                    if not g.get("equal", True):
                        out["ctx"][f"{bi}:{key}"] = g
        # 2-3: the element kernels, op by op, and their outputs
        kern = [(list(ops8.batches), list(opsR.batches))]
        logs = [[[] for _ in ops8.batches], [[] for _ in opsR.batches]]
        kout = [[None] * len(ops8.batches), [None] * len(opsR.batches)]
        for side, ops in enumerate((ops8, opsR)):
            wrapped = []
            for bi, (b, kf) in enumerate(ops.batches):
                def run(batch, u_e, ctx, kf=kf, bi=bi, side=side):
                    with _OpLog(logs[side][bi]):
                        y = kf(batch, u_e, ctx)
                    kout[side][bi] = y.detach().clone()
                    return y
                wrapped.append((b, run))
            ops.batches = wrapped
        z8 = torch.zeros_like(s8.u, dtype=ops8.dtype)
        zR = torch.zeros_like(uR, dtype=opsR.dtype)
        ops8.residual(z8)
        opsR.residual(zR)
        out["kernels"] = [
            {"batch": bi, "output": _gap(kout[0][bi], kout[1][bi], k, R),
             "ops": _first_op_gap(logs[0][bi], logs[1][bi], k, R)}
            for bi in range(len(ops8.batches))]
        ops8.batches, opsR.batches = kern[0]
        # 4: the summed scatter (K1) before the halo reduction
        out["scatter"] = _gap(red8[-1][0], redR[-1], k, R)
        # 5: the halo reduction on equal inputs, the payloads replayed
        replay = iter(list(payloads))

        def roll_replay(payload, d, move):
            dd, full = next(replay)
            assert dd == d
            return torch.roll(full, d, 0)[k * L:(k + 1) * L]

        dR._roll = roll_replay
        out["halo_reduce"] = _gap(
            red8[-1][1], DistributedSystem._halo_reduce(dR, red8[-1][0][ext]),
            k, R)
        # the element tangents of the node blocks, and the blocks' scatter
        if ops8.element_jacobian:
            T8, TR = ops8._all_tangents(z8), opsR._all_tangents(zR)
            out["tangents"] = [_gap(a, b, k, R) for a, b in zip(T8, TR)]
        ops8.jacobian_blocks(z8)
        opsR.jacobian_blocks(zR)
        out["blocks_scatter"] = _gap(red8[-1][0], redR[-1], k, R)
    finally:
        d8._halo_fill, d8._roll, d8._halo_reduce = fill8, roll8, reduce8
    return out


def _grad_by_terms(self, u_e: torch.Tensor) -> torch.Tensor:
    """`CellBatch.grad` as the explicit sum over the local nodes, in order:
    elementwise products, so a row's bits do not depend on how many rows
    there are (the einsum's batched GEMM picks its kernel by the batch
    count on the card)."""
    G = self.grads                               # [c, q, a, d]
    tail = (1,) * (u_e.dim() - 2)
    g = None
    for a in range(G.shape[2]):
        term = (G[:, :, a, :].reshape(G.shape[:2] + G.shape[3:] + tail)
                * u_e[:, a].unsqueeze(1).unsqueeze(1))
        g = term if g is None else g + term
    return g.expand((g.shape[0], self.n_q) + tuple(g.shape[2:]))


def probe(device="cuda", nx=32, ny=64, species=18, n_parts=8, n_ranks=4,
          ranks=None, grad_by_terms=False) -> dict:
    """Every rank (or `ranks`) of `n_ranks` against the stacked run of
    `n_parts` parts; `grad_by_terms`: with the cells' gradient summed term
    by term in both (`_grad_by_terms`), the control that shows whether the
    einsum's GEMM is the only term that rounds by the row count."""
    import shutil
    from unittest import mock

    from ..fem.assembly import CellBatch
    from ..model.system import StepParams

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    build, tmp = _models(dev, nx, ny, species)
    patch = (mock.patch.object(CellBatch, "grad", _grad_by_terms)
             if grad_by_terms else contextlib.nullcontext())
    try:
        with patch:
            m8 = build()
            d8 = m8.distribute([dev] * n_parts)
            s8 = m8.initial_state()
            aux8 = m8._update_aux(s8.u)
            p = StepParams(s8.t + s8.dt, s8.dt, s8.dt_old)
            out = {"device": str(dev), "parts": n_parts, "ranks": n_ranks,
                   "n_ext": d8.n_ext, "n_own_max": d8.n_own_max,
                   "grad_by_terms": grad_by_terms}
            out["by_rank"] = [
                _rank(build, d8, s8, aux8, p, dev, n_ranks, k)
                for k in (range(n_ranks) if ranks is None else ranks)]
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nx", type=int, default=32)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--species", type=int, default=18)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--grad-by-terms", action="store_true",
                    help="the control: the cells' gradient summed term by "
                         "term (no batched GEMM) in both runs")
    ap.add_argument("--rank", type=int, action="append",
                    help="probe only this rank (repeatable; default all)")
    a = ap.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device (pass --device cpu)")
    out = probe(a.device, a.nx, a.ny, a.species, a.parts, a.ranks, a.rank,
                a.grad_by_terms)
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
