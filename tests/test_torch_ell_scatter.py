"""The ELL gather-sum (K1) on the CPU: its plain PyTorch version against
the JAX package's Pallas kernel run in interpret mode, on the case of
tests/unit/test_pallas_scatter.py extended to a trailing width C, and the
wrapper's CPU dispatch. The CUDA kernel itself is held to the plain
version on the card by tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.ops.pallas_scatter import pallas_ell_scatter
from fedm_tpu_torch.ops.ell_scatter import (ell_scatter, ell_scatter_ref,
                                            launch_count)


def _case(C, seed=0):
    rng = np.random.default_rng(seed)
    n_flat, n_dofs, val = 301, 100, 7
    flat = rng.standard_normal((n_flat, C))
    idx = rng.integers(0, n_flat, (n_dofs, val))
    # sprinkle sentinel entries (padding)
    idx[rng.random((n_dofs, val)) < 0.2] = n_flat
    return flat, idx


@pytest.mark.parametrize("C", [1, 3])
def test_plain_version_matches_pallas_interpret(C):
    flat, idx = _case(C)
    got = ell_scatter_ref(torch.as_tensor(flat, dtype=torch.float32),
                          torch.as_tensor(idx, dtype=torch.int32)).numpy()
    # the Pallas kernel takes one trailing component per call, with the
    # sentinel zero row appended
    for c in range(C):
        ref = pallas_ell_scatter(
            jnp.asarray(np.append(flat[:, c], 0.0), jnp.float32),
            jnp.asarray(idx, jnp.int32), tile=32, interpret=True)
        np.testing.assert_allclose(got[:, c], np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("trailing", [(), (3,), (3, 3)])
def test_cpu_tensors_take_the_plain_version(trailing):
    rng = np.random.default_rng(1)
    flat = torch.as_tensor(rng.standard_normal((50,) + trailing))
    idx = torch.as_tensor(rng.integers(0, 60, (20, 4)), dtype=torch.int32)
    before = launch_count("ell_scatter")
    out = ell_scatter(flat, idx)
    assert launch_count("ell_scatter") == before  # no kernel on the CPU
    assert out.shape == (20,) + trailing and out.dtype == torch.float64
    # entries >= n_flat (the sentinel and anything past it) read zero
    f = flat.reshape(50, -1).numpy()
    i = idx.numpy()
    ref = np.where((i < 50)[..., None], f[np.minimum(i, 49)], 0.0).sum(1)
    np.testing.assert_allclose(out.reshape(20, -1).numpy(), ref, rtol=1e-15,
                               atol=1e-15)


def test_rejects_a_flat_index_table():
    with pytest.raises(ValueError):
        ell_scatter(torch.zeros(5), torch.zeros(5, dtype=torch.int32))
