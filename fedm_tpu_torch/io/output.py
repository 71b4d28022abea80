"""Time-interpolated output scheduling, the JAX package's `file_output`.

The reference's `file_output` semantics (`fedm/file_io.py:538-616`): the
user supplies interval
lists `t_out_list` / `step_list`; whenever the simulation passes a
scheduled output time, values are written at that exact time by LINEAR
interpolation between the previous and current accepted states, and the
output cadence switches per interval (with the reference's 0.999
thresholds). Unit scaling ns/us/ms/s applies to the recorded timestamp.
"""

from __future__ import annotations

from typing import List, Sequence

from .vtu import _host

_UNITS = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}


class OutputSeries:
    """One output variable: a writer plus how to extract its values."""

    def __init__(self, writer, extract, kind: str = "xdmf",
                 field_name: str = None):
        self.writer = writer
        self.extract = extract  # state_u -> nodal values
        self.kind = kind
        self.field_name = field_name


def file_output(
    t: float,
    t_old: float,
    t_out: float,
    step: float,
    t_out_list: Sequence[float],
    step_list: Sequence[float],
    series: List[OutputSeries],
    u_new,
    u_old,
    mesh=None,
    unit: str = "s",
):
    """Write every scheduled output time in (t_out..t]; returns the updated
    (t_out, step). `u_new`/`u_old` are the accepted states at `t`/`t_old`
    (numpy, or tensors on any device: the interpolation runs in numpy)."""
    try:
        scale = _UNITS[unit]
    except KeyError:
        raise ValueError(
            f"unit '{unit}' not valid; options are {sorted(_UNITS)}")

    if t > max(t_out_list):
        index = len(t_out_list) - 1
    else:
        index = next(x for x, val in enumerate(t_out_list) if val > t)

    u_new, u_old = _host(u_new), _host(u_old)
    while t_out <= t:
        frac_num = (t_out - t_old)
        denom = (t - t_old) if t != t_old else 1.0
        u_at = u_old + frac_num * (u_new - u_old) / denom
        for s in series:
            values = s.extract(u_at)
            if s.kind == "pvd":
                s.writer.write(mesh, values, t_out * scale,
                               field_name=s.field_name)
            elif s.kind == "xdmf":
                s.writer.write_checkpoint(values, t_out * scale)
            else:
                raise ValueError(
                    f"file type '{s.kind}' not recognised; options are "
                    "'pvd' and 'xdmf'")
        if (t_out >= 0.999 * t_out_list[index - 1]
                and t_out < 0.999 * t_out_list[index]):
            step = step_list[index - 1]
        elif t_out >= 0.999 * t_out_list[index]:
            step = step_list[index]
        # if neither branch hits, the cadence is left unchanged, as in the
        # reference (its FIXME at file_io.py:614)
        t_out += step
    return t_out, step
