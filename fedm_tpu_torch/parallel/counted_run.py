"""The Bagheri entry point as a user runs it, with its Newton and Krylov
iterations counted:

    python -m fedm_tpu_torch.parallel.counted_run COUNTS.jsonl \\
        --preset bagheri14-fullgap --devices 4 --precond mg --out DIR ...

runs `python -m fedm_tpu_torch.bagheri_run` with the arguments after the
first, and appends to COUNTS.jsonl, from every rank (or the one
process), one JSON line per advance of its adaptive driver: the rank,
the accepted and rejected counts, t and dt after it, and over its
attempts the Newton iterations, the Krylov iterations (BiCGStab and
GMRES summed) and K1's launches on the rank's card. The entry
point's own logs hold no Krylov counts (as the JAX tool's hold none);
`chip_smoke.py` phase 12 records them. The counters
are installed when this module is a process's main module, so the ranks
that `parallel.ranks` spawns (which import the main module again) count
too.
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import ell_scatter as k1
from ..solvers import newton
from ..timestepping import driver
from .rank_checks import _counting

# this advance's iterations by solver (`rank_checks._counting`'s)
_COUNTS: dict = {}
_LOG: list = []


def _advance_logged(advance):
    def run(self, state, *args, **kw):
        _COUNTS.clear()
        _LOG.clear()
        launched = sum(k1.LAUNCHES.values())
        out = advance(self, state, *args, **kw)
        rank = (torch.distributed.get_rank()
                if torch.distributed.is_initialized() else 0)
        line = json.dumps({
            "rank": rank, "n_accepted": out.n_accepted,
            "n_rejected": out.n_rejected, "t": out.t, "dt": out.dt,
            "newton": _COUNTS.get("newton_iteration", 0),
            "krylov": _COUNTS.get("bicgstab", 0) + _COUNTS.get("gmres", 0),
            "k1_launches": sum(k1.LAUNCHES.values()) - launched})
        with open(sys.argv[1], "a") as f:   # one short write: appends
            f.write(line + "\n")           # of the ranks do not mix
        return out

    return run


def _install() -> None:
    for name in ("newton_iteration", "bicgstab", "gmres"):
        setattr(newton, name,
                _counting(_COUNTS, _LOG, name, getattr(newton, name)))
    driver.AdaptiveDriver.advance = _advance_logged(
        driver.AdaptiveDriver.advance)


# as the main module of a process: the run itself, or one of the ranks it
# spawns (which imports it again as "__mp_main__"); imported otherwise, it
# changes nothing
if __name__ in ("__main__", "__mp_main__"):
    _install()

if __name__ == "__main__":
    from .. import bagheri_run

    sys.exit(bagheri_run.main(sys.argv[2:]))
