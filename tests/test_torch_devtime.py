"""`devtime._profiled_ms`'s count of the flush's kernels in the trace of
the timed calls, with the profiler's traces stubbed (no card needed): an
exact count gives the time of the other kernels, a surplus (a timed call
ran a kernel of the flush's name) raises, and a shortfall (a trace dropped
in part) is traced again and then sent to CUDA events."""

from types import SimpleNamespace

import pytest

from fedm_tpu_torch import devtime


def _event(name, us):
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=0, end=us))


def _profiled(monkeypatch, timed_traces):
    """`_profiled_ms` over two calls with a flush, the flush's trace one
    kernel `flush_k`, the timed traces taken from `timed_traces` in turn;
    returns (result or exception, number of timed traces taken)."""
    timed = iter(timed_traces)
    taken = []

    def traced(run):
        if run is flush:
            return [_event("flush_k", 7.0)]
        taken.append(1)
        return next(timed)

    def flush():
        pass

    monkeypatch.setattr(devtime, "_traced", traced)
    try:
        return devtime._profiled_ms(lambda: None, [(), ()], flush), len(taken)
    except Exception as e:  # noqa: BLE001 - the test inspects it
        return e, len(taken)


def test_exact_count_leaves_the_flush_out(monkeypatch):
    trace = [_event("flush_k", 7.0), _event("k", 3000.0),
             _event("flush_k", 7.0), _event("k", 5000.0)]
    got, taken = _profiled(monkeypatch, [trace])
    assert got == pytest.approx(4.0) and taken == 1


def test_a_timed_kernel_of_the_flush_name_raises(monkeypatch):
    trace = [_event("flush_k", 7.0), _event("flush_k", 3000.0),
             _event("flush_k", 7.0), _event("k", 5000.0)]
    got, taken = _profiled(monkeypatch, [trace])
    assert isinstance(got, RuntimeError)
    assert not isinstance(got, devtime.NoDeviceEvents)
    assert "same name" in str(got) and taken == 1


@pytest.mark.parametrize("recovers", [True, False])
def test_a_partly_dropped_trace_is_taken_again(monkeypatch, recovers):
    dropped = [_event("k", 3000.0), _event("flush_k", 7.0),
               _event("k", 5000.0)]
    whole = [_event("flush_k", 7.0), _event("k", 3000.0),
             _event("flush_k", 7.0), _event("k", 5000.0)]
    traces = [dropped] * (devtime.PROFILE_ATTEMPTS - 1) + [
        whole if recovers else dropped]
    got, taken = _profiled(monkeypatch, traces)
    assert taken == devtime.PROFILE_ATTEMPTS
    if recovers:
        assert got == pytest.approx(4.0)
    else:
        assert isinstance(got, devtime.NoDeviceEvents)
