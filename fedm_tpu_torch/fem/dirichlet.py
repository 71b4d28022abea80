"""Dirichlet boundary conditions as residual masking: constrained residual
entries become `u - g`, which makes their Jacobian rows identity rows."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from .space import FunctionSpace


@dataclass
class DirichletBC:
    """Fix equation component `eq` to `value` (a scalar or an array over
    `dofs`) on the given dofs."""

    dofs: np.ndarray
    eq: int
    value: Union[float, np.ndarray]


class BCSet:
    """A set of Dirichlet BCs on a [n_dofs, n_eq] state held on `device`:
    `mask` marks the constrained entries, `values` holds their float64
    values (zero elsewhere)."""

    def __init__(self, space: FunctionSpace, n_eq: int, bcs: list,
                 *, device):
        self.bcs = list(bcs)
        self.n_eq = n_eq
        self.device = torch.device(device)
        mask = np.zeros((space.n_dofs, n_eq), dtype=bool)
        for bc in self.bcs:
            mask[np.asarray(bc.dofs), bc.eq] = True
        self.mask = torch.as_tensor(mask, device=self.device)

        g = np.zeros((space.n_dofs, n_eq))
        for bc in self.bcs:
            g[np.asarray(bc.dofs), bc.eq] = bc.value
        self.values = torch.as_tensor(g, device=self.device)
