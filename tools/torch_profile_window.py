"""Where the time of the port's moving-window path goes, on the GPU: the
Bagheri streamer at the `bagheri14` protocol of
`python -m fedm_tpu_torch.bagheri_run` (30,305 dofs, the window at the
seed) from t = 0. Times the initial state (the Poisson solve) and one
`move_window`, then runs `--warmup` advances and profiles `--advances`
more under `torch.profiler`. Prints, per profiled advance, its wall time,
the device-busy time (the union of kernel intervals), the idle share, the
kernel count and K1's launches, then the kernels and operators that take
the most device time.

    python tools/torch_profile_window.py [--warmup 2] [--advances 1]
        [--top 25]
"""

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT.parent))
sys.path.insert(0, str(ROOT))

from torch_profile_step import busy_us  # noqa: E402

from fedm_tpu_torch.bagheri_run import (build_driver, build_models,  # noqa: E402
                                        parse_args, window_corr)
from fedm_tpu_torch.ops.ell_scatter import (ell_scatter,  # noqa: E402
                                            ell_scatter_add_)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--advances", type=int, default=1)
    ap.add_argument("--top", type=int, default=25)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        args = parse_args(["--preset", "bagheri14", "--no-direct-rescue",
                           "--out", tmp])
        model, fallback = build_models(
            args, window_corr(1e-2, args.window_span, args.window_dz))
        print(f"card: {card}; {model.space.n_dofs} dofs")
        torch.cuda.synchronize()
        t = time.perf_counter()
        state = model.initial_state()
        torch.cuda.synchronize()
        print(f"initial state {time.perf_counter() - t:.3f} s (Poisson CG "
              f"{model.initial_poisson[1]} iterations, relres "
              f"{model.initial_poisson[0]:.2e})")
        t = time.perf_counter()
        state = model.move_window(
            window_corr(9.9e-3, args.window_span, args.window_dz), state)
        torch.cuda.synchronize()
        print(f"move_window {time.perf_counter() - t:.3f} s")
        driver = build_driver(args, model, fallback)
        for _ in range(opts.warmup):
            state = driver.advance(state)
        torch.cuda.synchronize()
        for _ in range(opts.advances):
            ell_scatter.launches = ell_scatter_add_.launches = 0
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                acc, rej = state.n_accepted, state.n_rejected
                state = driver.advance(state)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = busy_us(kernels) * 1e-6
            k1 = [e for e in kernels if "ell_scatter" in e.name]
            k1_s = sum(e.time_range.end - e.time_range.start
                       for e in k1) * 1e-6
            print(f"advance to t = {state.t:.4e}: wall {wall:.3f} s, device "
                  f"busy {busy:.3f} s, idle share {1 - busy / wall:.1%}, "
                  f"{len(kernels)} device kernels, accepted "
                  f"{state.n_accepted - acc}, rejected "
                  f"{state.n_rejected - rej}; K1 launches compact "
                  f"{ell_scatter_add_.launches}, dense {ell_scatter.launches}"
                  f", {k1_s * 1e6:.1f} us of device time")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                     row_limit=opts.top))


if __name__ == "__main__":
    main()
