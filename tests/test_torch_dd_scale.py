"""The port's domain-decomposition scale run, `python -m
fedm_tpu_torch.dd_scale` (the port of `tools/dd_scale.py`).

- At its full size (280 x 560, `mg_levels=1`, 8 parts) the partition is
  the JAX tool's, exactly: 157,641 dofs, 472,923 unknowns and 20,196 own
  + 562 ghost rows per part (`bench_assets/dd_scale_r03.log`), built on
  the CPU without stepping; the stacked tables list their live rows
  only, with no slot for the padded elements (1,136 x 2 for the
  electrode facets).
- At 16 x 24 one step on 8 parts against the JAX package's undistributed
  step of the same configuration: the same Newton iterations, the step
  error within 1e-12 relative and the state within 1e-13 of each
  column's max (CPU gaps 1.5e-14 and 5.9e-16), and the port's own
  undistributed step beside it, held to the same."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.models.streamer import StreamerConfig as JaxConfig
from fedm_tpu.models.streamer import StreamerModel as JaxModel
from fedm_tpu_torch import dd_scale
from fedm_tpu_torch.models.streamer import StreamerConfig, StreamerModel

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_full_size_partition_is_the_jax_tools():
    m = StreamerModel(StreamerConfig(nx=280, ny=560, mg_levels=1),
                      device="cpu")
    assert m.system.n_dofs == 157641
    assert m.system.n_dofs * m.n_eq == 472923
    d = m.distribute(["cpu"] * 8)
    assert (d.n_own_max, d.n_ghost_max) == (20196, 562)
    # both batches scatter over their live rows only, with no slot for
    # their padded elements (the facets' pads are most of the table)
    for (b, _), (src, _) in zip(d._batches, d.inner._batches()):
        assert b.scatter_rows is not None
        n_slots = int((b.scatter_idx < b.dofs.numel()).sum())
        assert n_slots == src.dofs.numel() <= b.dofs.numel()
    fb, src = d._batches[1][0], d.inner.facet_kernels[0][0]
    assert tuple(fb.scatter_idx.shape) == (1136, 2)
    assert src.dofs.numel() < fb.dofs.numel()   # 8 parts' pads


def test_one_step_against_the_jax_step(capsys):
    out = dd_scale.main(["--nx", "16", "--ny", "24", "--steps", "1",
                         "--device", "cpu"])
    printed = capsys.readouterr().out
    cfg = JaxConfig(nx=16, ny=24, mg_levels=1)
    jm = JaxModel(cfg)
    st = jm.make_driver(verbose=True).advance(jm.initial_state(), {})
    jax_iters = re.findall(r"iters=(\d+)", capsys.readouterr().out)
    ref_u, ref_err = np.asarray(st.u), st.max_error[0]
    iters = re.findall(r"iters=(\d+)", printed)
    assert len(jax_iters) == 1 and iters == jax_iters * 2
    for _, _, err in (out["steps"][0], out["undistributed"][0]):
        assert abs(err - ref_err) <= 1e-12 * ref_err
    scale = np.abs(ref_u).max(axis=0)
    for u in (out["u"].numpy(), out["u_undistributed"].numpy()):
        assert (np.abs(u - ref_u).max(axis=0) <= 1e-13 * scale).all()
    assert re.search(r"partition: \d+ own \+ \d+ ghost rows/device",
                     printed)
    assert re.search(r"step 1: [0-9.]+s on 8 parts, [0-9.]+s "
                     r"undistributed", printed)


def test_no_cuda_device_means_no_run(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "fedm_tpu_torch.dd_scale",
                        "--nx", "8", "--ny", "8"], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode != 0 and "--device cpu" in r.stderr
    assert r.stdout == ""
