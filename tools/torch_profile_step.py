"""Where the time of one adaptive advance of the PyTorch port goes, on the
GPU: the bench configuration (`bench.py:_stiff_bench`) restarted from the
bench checkpoint, one warm-up advance, then one advance under
`torch.profiler`. Prints the advance's wall time, the device-busy time
(the union of kernel intervals), the kernel count, K1's launches (both
forms) and its share of the advance's device time, and the kernels and
operators that take the most device time.

    python tools/torch_profile_step.py [--top 25]
"""

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fedm_tpu_torch.io import load_checkpoint  # noqa: E402
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel  # noqa: E402
from fedm_tpu_torch.ops.ell_scatter import (ell_scatter,  # noqa: E402
                                            ell_scatter_add_)
from fedm_tpu_torch.solvers.newton import NewtonConfig  # noqa: E402


def busy_us(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    nc = NewtonConfig(rtol=1e-3, max_iter=20, linear_tol=3e-2,
                      linear_maxiter=400, accept_reduction=3e-2,
                      hi_residual=True)
    cfg = StreamerConfig(dtype=torch.float32, newton=nc,
                         z_corridor=(0.0, 1.08e-2, 1e-5),
                         density_floor=1e13, r_corridor=(2e-3, 2e-5))
    model = StreamerModel(cfg, device="cuda")
    model.system.use_gather_scatter()
    state = load_checkpoint(ROOT / "bench_assets" / "bagheri_dz1e-5_ckpt.npz",
                            device="cuda")
    driver = model.make_driver(verbose=True)
    state = driver.advance(state)
    torch.cuda.synchronize()
    ell_scatter.launches = ell_scatter_add_.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state = driver.advance(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_us(kernels) * 1e-6
    k1 = [e for e in kernels if "ell_scatter" in e.name]
    k1_s = sum(e.time_range.end - e.time_range.start for e in k1) * 1e-6
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"advance wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({busy / wall:.1%}), idle share {1 - busy / wall:.1%}, "
          f"{len(kernels)} device kernels, accepted {state.n_accepted}, "
          f"rejected {state.n_rejected}")
    print(f"K1 launches: compact {ell_scatter_add_.launches}, dense "
          f"{ell_scatter.launches}; {len(k1)} K1 kernels in the trace, "
          f"{k1_s * 1e6:.1f} us of device time, {k1_s / busy:.3e} of the "
          f"advance's")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                     row_limit=args.top))


if __name__ == "__main__":
    main()
