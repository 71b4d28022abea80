"""One process (rank) per card: the process group, its launcher, and the
collectives the distributed solvers take.

The JAX package runs one SPMD program over a device mesh (`shard_map`,
GSPMD); the reference runs `mpirun -np N`. The port runs one process per
card, joined by `torch.distributed`: NCCL on CUDA (each rank on card
`rank`, after `torch.cuda.set_device(rank)`), gloo on the CPU. NCCL
refuses two ranks on one GPU, so a rank holds several parts of a domain
decomposition, or several members of a sweep, stacked.

    launch(fn, n_ranks, "cuda", args)   # fn(group, *args) on every rank

`launch` spawns the ranks with `torch.multiprocessing.spawn`, joined by a
`file://` store in a temporary directory, and returns each rank's return
value (rank order). A rank that raises or dies makes it raise; so does a
run that outlasts its `timeout`, whose ranks are then killed. Every
process group is made with a collective timeout (`PG_TIMEOUT_S`), so a
missed collective fails the run instead of hanging it. Under `torchrun`
(its environment set) `ranked` joins that group instead of spawning, and
a one-rank group is made in the calling process (`one_rank`), with no
spawn and no backend: over one rank every collective is the identity.

Nothing here falls back to fewer cards or to the CPU: asking for more
ranks than there are CUDA devices raises.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist

PG_TIMEOUT_S = 120.0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class Group:
    """The process group of this rank: `rank` of `size`, on `device`.
    Every method is a collective: every rank calls it, in the same order,
    with tensors of the same shapes. Over one rank each is the identity
    and calls no backend (a one-rank reduction or gather changes no bit)."""

    def __init__(self, rank: int, size: int, device):
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: `t` reduced elementwise over the ranks (op sum,
        max or min). Pack scalars into one tensor to reduce them in one
        call."""
        if self.size == 1:
            return t
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, op=_OPS[op])
        return out

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes), concatenated along the first
        axis in rank order."""
        if self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts)

    def exchange(self, sends: Sequence, recvs: Sequence) -> None:
        """Point to point: each (peer, tensor) of `sends` goes to that
        peer, each (peer, buffer) of `recvs` is filled from it, in one
        `batch_isend_irecv`; returns when every transfer is complete (on
        the device, ordered before the current stream's later work)."""
        ops = ([dist.P2POp(dist.isend, t.contiguous(), peer)
                for peer, t in sends]
               + [dist.P2POp(dist.irecv, buf, peer) for peer, buf in recvs])
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def check_same(self, value: int, what: str) -> None:
        """Raise on every rank unless the integer `value` is the same on
        all of them."""
        v = torch.tensor([value, -value], dtype=torch.int64,
                         device=self.device)
        m = self.all_reduce(v, "max")
        if int(m[0]) != value or int(m[1]) != -value:
            raise RuntimeError(f"{what} differs between the ranks "
                               f"(rank {self.rank}: {value})")


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_cards(n_ranks: int, device, n_parts: int = None) -> None:
    """Raise ValueError unless `n_ranks` ranks can each have a card of
    their own (on the CPU, any number can run) and, given `n_parts`, hold
    an equal share of them."""
    if n_parts is not None and n_parts % max(n_ranks, 1):
        raise ValueError(f"{n_ranks} cards must divide the {n_parts} parts")
    if n_ranks < 1:
        raise ValueError(f"{n_ranks} ranks: at least one is needed")
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_ranks > have:
            raise ValueError(f"{n_ranks} ranks need {n_ranks} CUDA devices, "
                             f"one each; this machine has {have}")


def _init(rank: int, size: int, device, init_method: str,
          timeout_s: float) -> Group:
    dev = torch.device(device)
    if dev.type == "cuda":
        index = rank if dev.index is None else dev.index
        torch.cuda.set_device(index)
        dev = torch.device("cuda", index)
    dist.init_process_group(_backend(dev), init_method=init_method,
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Group(rank, size, dev)


@contextlib.contextmanager
def one_rank(device):
    """A one-rank group in this process (no spawn, no backend): the ranked
    code with every exchange local and every collective the identity
    (`Group` over one rank)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    yield Group(0, 1, dev)


def _entry(rank: int, fn: Callable, size: int, device, tmp: str,
           args: tuple, timeout_s: float) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    group = _init(rank, size, device, f"file://{tmp}/store", timeout_s)
    try:
        result = fn(group, *args)
        torch.save(result, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, device="cuda", args: tuple = (),
           timeout: float = 1800.0,
           pg_timeout: float = PG_TIMEOUT_S) -> List:
    """Run fn(group, *args) on `n_ranks` spawned ranks, rank r on card r
    (on the CPU, every rank on the CPU, one thread each) and return their
    return values in rank order. `fn` must be importable by name (a
    module-level function), its return value picklable. Raises when a rank
    raises or exits non-zero, or when the run outlasts `timeout` seconds
    (its ranks killed); each collective gives up after `pg_timeout`."""
    import torch.multiprocessing as mp

    check_cards(n_ranks, device)
    tmp = tempfile.mkdtemp(prefix="fedm_ranks_")
    ctx = None
    try:
        ctx = mp.spawn(_entry, args=(fn, n_ranks, str(device), tmp, args,
                                     pg_timeout),
                       nprocs=n_ranks, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n_ranks} ranks of {fn.__name__} ran "
                                   f"past {timeout:g} s; killed")
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(n_ranks)]
    finally:
        # whatever ends the wait (a failed rank, the time limit, a signal
        # in this process) ends every rank still running
        for p in (ctx.processes if ctx is not None else []):
            if p.is_alive():
                p.kill()
            p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)


def under_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def ranked(fn: Callable, n_ranks: int, device, args: tuple = ()) -> List:
    """fn(group, *args) on `n_ranks` ranks: in a `torchrun` group, each
    process runs its own rank and gets [its value]; one rank runs in this
    process (`one_rank`); more are spawned (`launch`) and every return
    value comes back in rank order."""
    if under_torchrun():
        size = int(os.environ["WORLD_SIZE"])
        if size != n_ranks:
            raise ValueError(f"torchrun started {size} ranks, not "
                             f"{n_ranks}")
        rank = int(os.environ["RANK"])
        dev = torch.device(device)
        if dev.type == "cuda":
            check_cards(size, dev)
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                          rank)))
        group = _init(rank, size, dev, "env://", PG_TIMEOUT_S)
        try:
            return [fn(group, *args)]
        finally:
            dist.destroy_process_group()
    if n_ranks == 1:
        check_cards(1, device)
        with one_rank(device) as group:
            return [fn(group, *args)]
    return launch(fn, n_ranks, device, args)



def part_devices(n: int, group: Group) -> list:
    """The part-to-device list of `n` parts (or members) in even blocks
    over the group's ranks: this rank's block on its device, rank q's on
    card q (all on the CPU under gloo)."""
    if n % group.size:
        raise ValueError(f"{n} parts do not split evenly over "
                         f"{group.size} ranks")
    cuda = group.device.type == "cuda"
    return [str(group.device) if q == group.rank
            else (f"cuda:{q}" if cuda else "cpu")
            for q in range(group.size) for _ in range(n // group.size)]
