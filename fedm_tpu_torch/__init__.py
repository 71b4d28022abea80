"""fedm_tpu_torch — the PyTorch/CUDA port of fedm_tpu.

A second implementation of the JAX package's plasma fluid-Poisson framework
for NVIDIA Hopper GPUs, mirroring its layout (`mesh/`, `fem/`, `ops/`,
`model/`, `models/`, `solvers/`, `timestepping/`, `io/`). It imports torch
and numpy only. The JAX package stays the reference: the tests feed both the
same inputs and compare.

State is float64 on the device with the increment formulation; the element
kernels and Krylov vectors run in the configured compute dtype (float32 on
the fast path) with float64 reductions. Entry points take a `device`
argument, "cuda" by default. The TPU kernel of the JAX package is a
hand-written CUDA kernel here (`csrc/`, built with nvcc at first use).
"""

__version__ = "0.1.0"

from . import constants  # noqa: E402

__all__ = ["constants"]
