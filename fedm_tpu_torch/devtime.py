"""Device timing on the GPU, shared by chip_smoke.py, the entry points
and the measurement scripts under tools/: the device time of a call from
a profiler trace (or, where the profiler drops its traces, from CUDA
events around each call queued behind a spin kernel), cold (L2 flushed
before every call) or warm, the host-issue rate of eager calls from CUDA
events, and a rank's wall time on its own card with the card it ran on.

    flush = l2_flush()
    cold = device_ms(fn, [(x,)] * 20, flush)
    warm = device_ms(fn, [(x,)] * 20)
    out, seconds = on_card(fn, device)     # card_of(device): which card
"""

from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
L2_BYTES = 50 * 2**20      # H100 SXM L2 cache
SPIN_CYCLES = 10**8        # ~50 ms at the H100's 1.98 GHz boost clock


PROFILE_ATTEMPTS = 5
# device_ms calls that fell back to event_ms in this process
event_fallbacks = 0


class NoDeviceEvents(RuntimeError):
    """The profiler recorded no device event in any of its traces."""


def l2_flush(device="cuda"):
    """A call that evicts L2: row maxima of a buffer of twice its size. It
    reads the buffer and writes 1/64 of it, so it leaves few dirty lines
    whose write-back the timed call would pay for (an in-place pass leaves
    all of L2 dirty). Short rows keep it to one reduction kernel."""
    rows = torch.zeros((2 * L2_BYTES // 512, 64), dtype=torch.int64,
                       device=device)
    return lambda: rows.amax(dim=1)


def card_of(device) -> dict:
    """Which card `device` is: its index, name and UUID (on the CPU, the
    device name alone)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": str(dev)}
    index = torch.cuda.current_device() if dev.index is None else dev.index
    props = torch.cuda.get_device_properties(index)
    return {"device": f"cuda:{index}", "name": props.name,
            "uuid": str(getattr(props, "uuid", ""))}


def on_card(fn, device):
    """(fn(), wall seconds) on the host clock, the card `device`
    synchronized before and after: a rank's time for work on its own
    card (collectives included)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t


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
    none (the profiler on the card has dropped a whole trace, up to three
    times in a row) is taken again, up to PROFILE_ATTEMPTS traces in
    all."""
    for attempt in range(PROFILE_ATTEMPTS):
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
    raise NoDeviceEvents(f"the profiler recorded no device event in "
                         f"{PROFILE_ATTEMPTS} traces")


def event_ms(fn, calls, flush=None) -> float:
    """Device time per call from a CUDA event pair around each call
    fn(*args), one for each entry of `calls` (with `flush`, flush() runs
    before each, outside its pair). A spin kernel runs first, long enough
    that the host has queued every call before the device reaches the
    first one, so no pair holds a wait for the host; each pair still holds
    the gaps between the call's own kernels and the device's cost of the
    launch and the two records, ~4 us on an H100 (K1's compact calls:
    6.0-6.1 us by events, 2.1-2.2 us by the profiler)."""
    for args in calls:
        fn(*args)
    cycles = SPIN_CYCLES
    for _ in range(4):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in calls]
        spun = torch.cuda.Event()
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        spun.record()
        for (start, end), args in zip(pairs, calls):
            if flush is not None:
                flush()
            start.record()
            fn(*args)
            end.record()
        queued_in_time = not spun.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return sum(a.elapsed_time(b) for a, b in pairs) / len(calls)
        cycles *= 4
    raise RuntimeError("the device overtook the host in every event pass")


def device_ms(fn, calls, flush=None) -> float:
    """Device time per call: the summed durations of the kernels (and
    device copies) that the calls fn(*args), one for each entry of `calls`,
    run, from a profiler trace, with the idle gaps between launches left
    out. One untimed pass over `calls` comes first. With `flush`, flush()
    runs before every call and its kernels (named by a trace of flush
    alone) are left out. Where the profiler drops every trace, the time
    comes from `event_ms` instead: a line on stderr says so, and
    `event_fallbacks` counts it."""
    global event_fallbacks
    try:
        return _profiled_ms(fn, calls, flush)
    except NoDeviceEvents as e:
        print(f"devtime: {e}; timing with CUDA events instead",
              file=sys.stderr, flush=True)
        event_fallbacks += 1
        return event_ms(fn, calls, flush)


def _profiled_ms(fn, calls, flush=None) -> float:
    """The profiler's timing. The flush's kernels are counted in the trace
    of the timed calls: more than the flushes ran means a timed call ran a
    kernel of the flush's name, whose time would be left out, and raises;
    fewer means the profiler dropped part of the trace, and both traces are
    taken again, up to PROFILE_ATTEMPTS times, and then NoDeviceEvents
    sends `device_ms` to CUDA events."""
    for args in calls:
        fn(*args)

    def run():
        for args in calls:
            if flush is not None:
                flush()
            fn(*args)

    for attempt in range(PROFILE_ATTEMPTS):
        skip, per_flush = set(), 0
        if flush is not None:
            names = [e.name for e in _traced(flush)]
            skip, per_flush = set(names), len(names)
        events = _traced(run)
        skipped = sum(e.name in skip for e in events)
        expected = per_flush * (len(calls) if flush else 0)
        if skipped == expected:
            break
        if skipped > expected:
            raise RuntimeError("the timed calls ran a kernel of the same "
                               "name as the flush's")
        print(f"devtime: the trace holds {skipped} kernels of the flush's "
              f"names, not {expected} (attempt {attempt + 1}); tracing "
              f"again", file=sys.stderr, flush=True)
    else:
        raise NoDeviceEvents(f"every one of {PROFILE_ATTEMPTS} traces lost "
                             f"some of the flush's kernels")
    us = sum(e.time_range.end - e.time_range.start for e in events
             if e.name not in skip)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / len(calls) / 1e3
