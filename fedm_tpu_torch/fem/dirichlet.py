"""Dirichlet boundary conditions as residual masking: constrained residual
entries become `u - g`, which makes their Jacobian rows identity rows."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

import numpy as np
import torch

from .space import FunctionSpace


@dataclass
class DirichletBC:
    """Fix equation component `eq` to `value` on the given dofs: a scalar,
    an array over `dofs`, or a callable `t -> scalar/array` for a
    time-ramped condition (the glow's powered electrode
    `U0*(1-exp(-t/1e-9))`), evaluated in float64 on the host."""

    dofs: np.ndarray
    eq: int
    value: Union[float, np.ndarray, Callable]


class BCSet:
    """A set of Dirichlet BCs on a [n_dofs, n_eq] state held on `device`:
    `mask` marks the constrained entries, `values` holds their float64
    values at t = 0 (zero elsewhere) and `values_at(t)` at time t. The dof
    lists and the fixed values go to the device once; a time-dependent
    condition that gives a number is filled in on the device."""

    def __init__(self, space: FunctionSpace, n_eq: int, bcs: list,
                 *, device):
        self.bcs = list(bcs)
        self.n_eq = n_eq
        self.device = torch.device(device)
        mask = np.zeros((space.n_dofs, n_eq), dtype=bool)
        for bc in self.bcs:
            mask[np.asarray(bc.dofs), bc.eq] = True
        self.mask = torch.as_tensor(mask, device=self.device)

        self._timed = any(callable(bc.value) for bc in self.bcs)
        # per BC: its dofs on the device, its component, and its value
        # (a device tensor over the dofs, a number, or the callable)
        self._parts = [
            (torch.as_tensor(np.asarray(bc.dofs), dtype=torch.int64,
                             device=self.device), bc.eq,
             bc.value if callable(bc.value) or np.ndim(bc.value) == 0
             else torch.as_tensor(np.asarray(bc.value, np.float64),
                                  device=self.device))
            for bc in self.bcs]
        self.values = self._values(0.0)

    def _values(self, t: float) -> torch.Tensor:
        g = torch.zeros(tuple(self.mask.shape), dtype=torch.float64,
                        device=self.device)
        for dofs, eq, value in self._parts:
            v = value(t) if callable(value) else value
            if isinstance(v, torch.Tensor) or np.ndim(v):
                g[dofs, eq] = torch.as_tensor(v, dtype=torch.float64,
                                              device=self.device)
            else:
                g[:, eq].index_fill_(0, dofs, float(v))
        return g

    def values_at(self, t: float) -> torch.Tensor:
        """BC values at time `t` as a dense float64 [n_dofs, n_eq] tensor."""
        return self._values(float(t)) if self._timed else self.values


def combine_bcs(space: FunctionSpace, n_eq: int, bcs: list, *,
                device) -> BCSet:
    """The BCSet of `bcs` on a [n_dofs, n_eq] state (the JAX package's
    `combine_bcs`); on P2 spaces the dofs come from
    `FunctionSpace.boundary_dofs`, edge dofs included."""
    return BCSet(space, n_eq, bcs, device=device)
