"""Which index layout K1 (fedm_tpu_torch/csrc/ell_scatter.cu) should read,
measured on the GPU. Three ways to load the ELL table, each followed by the
same gather-sum:

  row-major   the port's kernel on the [n_rows, max_val] table as built
              (what the batches keep);
  slot-major  tools/k1_layouts.cu: the port's kernel on the table stored as
              its [max_val, n_rows] transpose: a warp's load of one slot is
              128 contiguous bytes;
  staged      tools/k1_layouts.cu: row-major tiles copied into shared
              memory by cp.async.bulk on an mbarrier, double-buffered in a
              persistent grid.

Cases: the compact form at the main path's electrode-facet shape (C = 3
and 9) and the dense form at the full-mesh cell shape, float32 and
float64, on the bench mesh. Each variant is checked against the plain
version, then timed cold (L2 flushed before every call; device time from a
profiler trace, `fedm_tpu_torch.devtime`, as chip_smoke.py times K1) in
turns A B C C B A within one
process.

    python tools/k1_layout_ab.py

Prints one line per case and layout, the card's name and power limit, then
one JSON line.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fedm_tpu_torch.devtime import device_ms, l2_flush  # noqa: E402
from fedm_tpu_torch.fem.assembly import (build_ell_index,  # noqa: E402
                                         build_ell_index_compact)
from fedm_tpu_torch.models.streamer import (StreamerConfig,  # noqa: E402
                                            StreamerModel)
from fedm_tpu_torch.ops import cuda_build  # noqa: E402
from fedm_tpu_torch.ops.ell_scatter import (ell_scatter,  # noqa: E402
                                            ell_scatter_add_,
                                            ell_scatter_add_ref,
                                            ell_scatter_ref)

TILE = 32  # rows per staged tile (kRows in k1_layouts.cu)
REPS = 20


def layouts_lib():
    lib = cuda_build.load(str(ROOT / "tools" / "k1_layouts.cu"))
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for kind in ("staged", "slot_major"):
        for s in ("f32", "f64"):
            fn = getattr(lib, f"ell_{kind}_{s}")
            fn.argtypes = [p, p, p, p, ll, i, ll, i, p]
            fn.restype = ctypes.c_int
    return lib


def variants(lib, idx_np, rows, flat):
    """name -> fn(out) for the three layouts; rows None is the dense form
    (out is then overwritten)."""
    idx_row = torch.as_tensor(idx_np, device="cuda")
    idx_slot = idx_row.t().contiguous()  # [max_val, n_rows]
    pad = -idx_np.shape[0] % TILE
    idx_pad = torch.cat([idx_row, idx_row.new_full((pad, idx_np.shape[1]),
                                                   flat.shape[0])])
    suffix = "f32" if flat.dtype == torch.float32 else "f64"
    stream = torch.cuda.current_stream().cuda_stream

    def tool(kind, idx):
        fn = getattr(lib, f"ell_{kind}_{suffix}")

        def call(out):
            if rows is None:
                out = torch.empty_like(out)
            err = fn(idx.data_ptr(), None if rows is None else
                     rows.data_ptr(), flat.data_ptr(), out.data_ptr(),
                     idx_np.shape[0], idx_np.shape[1], flat.shape[0],
                     flat.shape[1], stream)
            if err:
                raise RuntimeError(f"{kind} kernel launch failed: {err}")
            return out
        return call

    def row_major(out):  # the port's kernel
        if rows is None:
            return ell_scatter(flat, idx_row)
        return ell_scatter_add_(out, flat, idx_row, rows)

    return {"slot-major": tool("slot_major", idx_slot),
            "row-major": row_major, "staged": tool("staged", idx_pad)}


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    lib = layouts_lib()
    cfg = StreamerConfig(dtype=torch.float32,
                         z_corridor=(0.0, 1.08e-2, 1e-5),
                         density_floor=1e13, r_corridor=(2e-3, 2e-5),
                         poisson_precond="mg-zline")
    model = StreamerModel(cfg, device="cuda")
    fb = model.system.facet_kernels[0][0]
    n_dofs = model.space.n_dofs
    rows_np, facet_idx = build_ell_index_compact(fb.dofs_np, n_dofs)
    rows = torch.as_tensor(rows_np, device="cuda")
    cell_idx = build_ell_index(model.batch.dofs_np, n_dofs)
    shapes = [("facet compact C=3", facet_idx, rows, fb.dofs_np.size, 3),
              ("facet compact C=9", facet_idx, rows, fb.dofs_np.size, 9),
              ("cell dense C=3", cell_idx, None,
               model.batch.dofs_np.size, 3)]
    flush = l2_flush()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, idx_np, r, n_flat, C in shapes:
        for dtype in (torch.float32, torch.float64):
            flat = torch.randn((n_flat, C), generator=gen, device="cuda",
                               dtype=dtype)
            out0 = torch.randn((n_dofs, C), generator=gen, device="cuda",
                               dtype=dtype)
            idx_t = torch.as_tensor(idx_np, device="cuda")
            if r is None:
                ref = ell_scatter_ref(flat, idx_t)
            else:
                ref = ell_scatter_add_ref(out0.clone(), flat, idx_t, r)
            fns = variants(lib, idx_np, r, flat)
            tol = (1e-13 if dtype == torch.float64 else 1e-6) * float(
                ref.abs().max())
            for key, fn in fns.items():
                got = fn(out0.clone())
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if err > tol:
                    sys.exit(f"{name} {dtype} {key}: error {err:.3e} > "
                             f"{tol:.3e}")
            out = out0.clone()
            calls = [(out,)] * REPS
            times = {k: [] for k in fns}
            for key in list(fns) + list(fns)[::-1]:  # A B C C B A
                times[key].append(device_ms(fns[key], calls, flush))
            for key, ms in times.items():
                row = {"case": name, "dtype": str(dtype)[6:], "layout": key,
                       "ms": sum(ms) / len(ms), "ms_turns": ms}
                results.append(row)
                print(f"{name} {row['dtype']:8s} {key:10s} cold "
                      f"{row['ms'] * 1e3:7.2f} us (turns "
                      f"{', '.join(f'{t * 1e3:.2f}' for t in ms)})",
                      flush=True)
    print(card)
    print(json.dumps({"card": card, "cases": results}))


if __name__ == "__main__":
    main()
