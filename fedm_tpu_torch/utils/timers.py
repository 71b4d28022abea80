"""Profiling hooks: per-phase wall timers and named trace ranges.

`PhaseTimer` accumulates named-phase wall time, synchronising the device
of a given tensor before it stops the clock; `trace_annotation` opens an
NVTX range and a `torch.profiler.record_function` range of the same name,
so phases show in the traces `tools/torch_profile.py` reads.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import ExitStack, contextmanager

import torch


class PhaseTimer:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def phase(self, name: str, block_on=None):
        """Time the body as phase `name`; with `block_on` (a tensor) wait
        for its device's queued work before stopping the clock."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:<28} {tot:9.3f} s  ({n} calls, "
                         f"{tot / n * 1e3:8.2f} ms/call)")
        return "\n".join(lines)


@contextmanager
def trace_annotation(name: str):
    """A named range for the profiler's trace (and an NVTX range where
    CUDA is present). An exception of the body passes through unchanged."""
    with ExitStack() as stack:
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            stack.callback(torch.cuda.nvtx.range_pop)
        stack.enter_context(torch.profiler.record_function(name))
        yield
