"""The slab solves' checks of `chip_smoke.py` phase 12 on four cards,
without the rest of `--only cards`: job 1's slab probe (on card 0) beside
the two-card GPU tests `-k two_card_slab` (on cards 2-3), then job 1b
(`chip_smoke.slab_preconds`) and job 5 (`chip_smoke.slab_fullgap`) as
phase 12 runs them after job 4, under their own budget. Prints the cards'
name and power limit, then one JSON line of the timings and results;
the pytest output goes to OUT_DIR/pytest.out. Exits non-zero where a
check fails.

    python tools/chip_slab_jobs.py OUT_DIR
"""
import json
import os
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as c  # noqa: E402


def main():
    out_dir = sys.argv[1]
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout, flush=True)
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "2,3"}
    with open(f"{out_dir}/pytest.out", "w") as f:
        pyt = subprocess.Popen(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "gpu",
             "-q", "tests/test_torch_gpu.py", "-k", "two_card_slab"],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    emu = c.slab_probe_result(c.start_slab_probe())
    t_probe = time.perf_counter() - t0
    rc = pyt.wait(timeout=420)
    t_pytest = time.perf_counter() - t0
    print(f"probe {t_probe:.1f} s, pytest rc {rc} at {t_pytest:.1f} s",
          flush=True)
    signal.signal(signal.SIGALRM, c._on_alarm)
    c.budget(c.SLAB_FULLGAP_BUDGET_S)
    t = time.perf_counter()
    pre = c.slab_preconds(4, c.slab_specs()[0], emu)
    t1b = time.perf_counter() - t
    t = time.perf_counter()
    fg = c.slab_fullgap(4)
    t5 = time.perf_counter() - t
    signal.alarm(0)
    summary = {"pytest_rc": rc, "probe_s": t_probe, "pytest_s": t_pytest,
               "job1b_s": t1b, "job5_s": t5,
               "job1b": {k: {kk: vv for kk, vv in v.items()}
                         if isinstance(v, dict) else v
                         for k, v in pre.items()},
               "job5": {k: fg[k] for k in ("newton_krylov", "t_rel",
                                           "dt_rel", "max_rel_field_dev",
                                           "counts", "one_card_counts")},
               "job5_process_s": [fg["ranks"]["process_s"],
                                  fg["one_card"]["process_s"]],
               "k1_launches": [fg["ranks"]["k1_launches"],
                               fg["one_card"]["k1_launches"]],
               "total_s": time.perf_counter() - t0}
    print(json.dumps(summary, default=str), flush=True)
    return 0 if rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
