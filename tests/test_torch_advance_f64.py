"""The advances of test_torch_advance.py with float64 compute on both
sides: with rounding differences at float64 level the port follows the
JAX package's trajectory to 1e-10 in dt and 1e-12 of each field
component's magnitude (measured: 4e-13 and 4e-16)."""

import jax.numpy as jnp
import torch

from tests.test_torch_advance import N_ADVANCES, check_trajectories, run_both


def test_three_advances_float64(monkeypatch):
    pairs = run_both(monkeypatch, jnp.float64, torch.float64)
    assert pairs[-1][0].n_accepted == N_ADVANCES
    check_trajectories(pairs, dt_rtol=1e-10, field_rtol=1e-12)
