"""Device timing on the GPU, shared by chip_smoke.py and the measurement
scripts under tools/: the device time of a call from a profiler trace, cold
(L2 flushed before every call) or warm, and the host-issue rate of eager
calls from CUDA events.

    flush = l2_flush()
    cold = device_ms(fn, [(x,)] * 20, flush)
    warm = device_ms(fn, [(x,)] * 20)
"""

from __future__ import annotations

import sys

import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
L2_BYTES = 50 * 2**20      # H100 SXM L2 cache


def l2_flush(device="cuda"):
    """A call that evicts L2: row maxima of a buffer of twice its size. It
    reads the buffer and writes 1/64 of it, so it leaves few dirty lines
    whose write-back the timed call would pay for (an in-place pass leaves
    all of L2 dirty). Short rows keep it to one reduction kernel."""
    rows = torch.zeros((2 * L2_BYTES // 512, 64), dtype=torch.int64,
                       device=device)
    return lambda: rows.amax(dim=1)


def eager_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    """CUDA-event time per call over back-to-back eager calls: the rate at
    which the host can issue them, or the device run them if slower."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _traced(run) -> list:
    """The device events of a profiler trace of run(). A trace that holds
    none (the profiler on the card has dropped a whole trace) is taken
    again, at most twice."""
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
        print(f"devtime: the profiler trace held no device event "
              f"({len(prof.events())} host events, attempt {attempt + 1}); "
              f"tracing again", file=sys.stderr, flush=True)
    raise RuntimeError("the profiler recorded no device event in three "
                       "traces")


def device_ms(fn, calls, flush=None) -> float:
    """Device time per call: the summed durations of the kernels (and
    device copies) that the calls fn(*args), one for each entry of `calls`,
    run, from a profiler trace, with the idle gaps between launches left
    out. One untimed pass over `calls` comes first. With `flush`, flush()
    runs before every call and its kernels (named by a trace of flush
    alone) are left out."""
    for args in calls:
        fn(*args)
    skip, per_flush = set(), 0
    if flush is not None:
        names = [e.name for e in _traced(flush)]
        skip, per_flush = set(names), len(names)

    def run():
        for args in calls:
            if flush is not None:
                flush()
            fn(*args)

    events = _traced(run)
    skipped = sum(e.name in skip for e in events)
    if skipped != per_flush * (len(calls) if flush else 0):
        raise RuntimeError("the timed calls ran a kernel of the same name as "
                           "the flush's")
    us = sum(e.time_range.end - e.time_range.start for e in events
             if e.name not in skip)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / len(calls) / 1e3
