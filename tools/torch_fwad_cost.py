"""What forward-mode AD costs the port's Jacobian action on the host.

PyTorch's forward-mode AD gives an operand without a tangent (a constant
tensor or a Python scalar) a zero tangent of its own, whose arithmetic runs
through meta kernels on the host. Times, per call and on the host clock
after a synchronize: an elementwise product of a dual tensor with a Python
scalar, with a constant tensor and with another dual tensor, and the plain
product; then the glow's cell kernel (glow50, crossed 64 x 64 mesh) plainly
and under forward-mode AD (one Jacobian action's element work).

    python tools/torch_fwad_cost.py [--device cuda] [--reps 200]
"""

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.autograd.forward_ad as fwAD

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fedm_tpu_torch.glow_run import build_models, parse_args  # noqa: E402
from fedm_tpu_torch.model.system import StepParams, _jvp  # noqa: E402


def per_call_us(fn, reps: int, device) -> float:
    for _ in range(10):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=200)
    opts = ap.parse_args()
    dev = torch.device(opts.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__}, device {dev}")
    x = torch.randn(49152, 5, device=dev)
    c = torch.randn(49152, 5, device=dev)
    with fwAD.dual_level():
        d = fwAD.make_dual(x, torch.randn_like(x))
        cases = {"plain x * 2.0": lambda: x * 2.0,
                 "dual * 2.0": lambda: d * 2.0,
                 "dual * constant tensor": lambda: d * c,
                 "dual * dual": lambda: d * d}
        for name, fn in cases.items():
            print(f"{name}: {per_call_us(fn, opts.reps, dev):.1f} us/call")

    with tempfile.TemporaryDirectory() as tmp:
        args = parse_args(["--preset", "glow50", "--out", tmp, "--device",
                           opts.device])
        model, _ = build_models(args)
        s = model.initial_state()
        ops = model.system.operators(s.u, s.u_old1,
                                     StepParams(1e-13, 1e-13, 1e30),
                                     aux=model._update_aux(s.u))
        (batch, kernel), ctx = ops.batches[0], ops.ctxs[0]
        u_e = batch.gather(torch.zeros_like(s.u, dtype=ops.dtype))
        t_e = torch.randn_like(u_e)
        reps = max(opts.reps // 20, 3)
        plain = per_call_us(lambda: kernel(batch, u_e, ctx), reps, dev)
        jvp = per_call_us(lambda: _jvp(kernel, batch, ctx, u_e, t_e), reps,
                          dev)
        print(f"glow cell kernel ({batch.dofs.shape[0]} cells): plain "
              f"{plain / 1e3:.2f} ms/call, forward-mode AD "
              f"{jvp / 1e3:.2f} ms/call")


if __name__ == "__main__":
    main()
