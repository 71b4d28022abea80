"""`python -m fedm_tpu_torch.dd_scale` in two checkouts, on one card, in
the order A B B A: its step times side by side on the same host.

    python -m fedm_tpu_torch.dd_scale_ab PARENT_DIR CHANGE_DIR [--steps 2]
        [-- further dd_scale options]

Each run is a process started in that checkout's root, at dd_scale's
defaults (280 x 560, 8 parts stacked on the card) unless options follow
`--` (on the CPU: `-- --device cpu --nx 16 --ny 24`). Prints one JSON
object: per run, the checkout, the wall time of the process, the
distributed and undistributed step times (the first step includes the
warm-up), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

STEP = re.compile(r"step \d+: ([0-9.]+)s on \d+ parts, ([0-9.]+)s "
                  r"undistributed")


def card() -> str:
    """`nvidia-smi`'s name and power limit of card 0 ("not measured" where
    there is no nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError):
        return "not measured"


def run_once(root: Path, steps: int, timeout: float, extra=()) -> dict:
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fedm_tpu_torch.dd_scale", "--steps",
         str(steps), *extra], cwd=root, capture_output=True, text=True,
        timeout=timeout)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise RuntimeError(f"dd_scale in {root} failed: "
                           f"{proc.stderr[-2000:]}")
    pairs = STEP.findall(proc.stdout)
    return {"checkout": str(root), "process_s": wall,
            "step_s": [float(a) for a, _ in pairs],
            "undistributed_step_s": [float(b) for _, b in pairs]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", type=Path)
    ap.add_argument("b", type=Path)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("extra", nargs="*", help="after --: dd_scale options")
    args = ap.parse_args(argv)
    runs = [run_once(root, args.steps, args.timeout, args.extra)
            for root in (args.a, args.b, args.b, args.a)]
    out = {"card": card(), "order": "A B B A", "runs": runs}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
