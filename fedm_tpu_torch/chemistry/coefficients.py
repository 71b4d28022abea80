"""Transport and rate coefficients: a dependence tag plus its table,
constant or expression, evaluated on device tensors (the JAX package's
`chemistry/coefficients.py`). Dependence kinds:

transport (the reference FEDM's `Transport_coefficient_interpolation`):
  'const' -> ky / N0
  'Umean' -> interp(mean_energy) / N0
  'E/N'   -> interp(reduced_field) / N0
  'ESR'   -> kB * Tgas * mu / e        (Einstein relation)
  'Tgas'  -> interp(Tgas) / N0         (scalar)
  'fun:E' -> a field expression, evaluated inside the residual
  0       -> coefficient absent (missing mobility file), evaluates to 0

rate (`Rate_coefficient_interpolation`):
  'const', 'Umean', 'E/N' as above but WITHOUT the /N0 scaling,
  'Te'    -> interp(2*energy/(3*kB_eV)),
  'ElecDist' -> interp(mean_energy),
  'fun:Te,Tgas' / 'fun:Tgas' -> compiled expression of Te/Tgas scalars.

Tables are held as float64 numpy arrays and moved to a tensor's device
once per device (cached).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..constants import elementary_charge, kB, kB_eV
from ..ops.exprs import compile_expression
from ..ops.interp import lut_interp


@dataclass
class Coefficient:
    """One coefficient: a dependence tag plus its table/constant/expression."""

    dependence: Union[str, int]
    kx: object = 0.0
    ky: object = 0.0
    kind: str = "transport"  # 'transport' | 'rate'
    expression: Optional[Callable] = None  # compiled fun:* expression
    _tables: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        if (isinstance(self.dependence, str)
                and self.dependence.startswith("fun")
                and self.expression is None and isinstance(self.ky, str)):
            self.expression = compile_expression(self.ky)
        if isinstance(self.kx, (list, tuple, np.ndarray)) and np.ndim(
                self.kx) > 0:
            self.kx = np.asarray(self.kx, np.float64)
            self.ky = np.asarray(self.ky, np.float64)

    def _table(self, device):
        """(kx, ky) as float64 tensors on `device`."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                                device=device)
                for a in (self.kx, self.ky))
        return self._tables[device]

    def _interp(self, x: torch.Tensor) -> torch.Tensor:
        return lut_interp(x, *self._table(x.device))

    def evaluate(self, N0: float = 1.0, Tgas: float = 300.0, Te: float = 0.0,
                 energy: Optional[torch.Tensor] = None,
                 redfield: Optional[torch.Tensor] = None,
                 mu: Optional[torch.Tensor] = None,
                 like: Optional[torch.Tensor] = None):
        """Nodal coefficient values (or a scalar for the constant kinds).
        `like` supplies the type, device and shape of a full nodal result."""
        dep = self.dependence
        scale = (1.0 / N0) if self.kind == "transport" else 1.0
        if dep == 0:
            out = 0.0
        elif dep in ("const", "const."):
            out = self.ky * scale
        elif dep in ("Umean", "ElecDist"):
            # ElecDist: an EEDF-integrated rate tabulated against the mean
            # energy, interpolated like Umean
            out = self._interp(energy) * scale
        elif dep == "E/N":
            out = self._interp(redfield) * scale
        elif dep == "Te":
            out = self._interp(2.0 * energy / (3.0 * kB_eV))
        elif dep == "ESR":
            if mu is None:
                raise ValueError("ESR dependence requires the mobility 'mu'")
            out = kB * Tgas * mu / elementary_charge
        elif dep == "Tgas":
            dev = like.device if like is not None else "cpu"
            out = self._interp(torch.tensor(float(Tgas), dtype=torch.float64,
                                            device=dev)) * scale
        elif dep in ("fun:Te,Tgas", "fun:Tgas"):
            dev = like.device if like is not None else "cpu"

            def t(v):
                return torch.tensor(float(v), dtype=torch.float64, device=dev)

            out = self.expression(Te=t(Te), Tgas=t(Tgas))
        elif dep == "fun:E":
            raise ValueError(
                "fun:E coefficients are field expressions; call "
                ".expression(E_m=...) inside the residual kernel instead")
        else:
            raise ValueError(f"dependence '{dep}' not recognised")
        if like is not None:
            out = torch.as_tensor(out, dtype=like.dtype,
                                  device=like.device).expand(like.shape)
        return out

    def table_gradient(self) -> "Coefficient":
        """Derivative table d(ky)/d(kx) for the semi-implicit treatment
        (`np.gradient` of the table, as the reference scripts do). The kind
        is kept: for transport tables the /N0 applied at evaluation equals
        the reference's pre-scaled derivative tables."""
        if not (isinstance(self.dependence, str)
                and isinstance(self.kx, np.ndarray)):
            raise ValueError("table_gradient needs a tabulated dependence")
        return Coefficient(self.dependence, self.kx,
                           np.gradient(self.ky, self.kx), kind=self.kind)


class _CoefficientSet:
    kind = "transport"

    def __init__(self, coefficients: List[Coefficient]):
        self.coefficients = coefficients

    def __len__(self):
        return len(self.coefficients)

    def __getitem__(self, i) -> Coefficient:
        return self.coefficients[i]

    @property
    def dependences(self):
        return [c.dependence for c in self.coefficients]


class TransportCoefficients(_CoefficientSet):
    kind = "transport"

    @classmethod
    def read(cls, particle_names, transport_type, model, file_input):
        from .parsers import read_transport_coefficients

        kxs, kys, deps = read_transport_coefficients(
            particle_names, transport_type, model, file_input=file_input)
        return cls([Coefficient(d, kx, ky, kind="transport")
                    for d, kx, ky in zip(deps, kxs, kys)])


class RateCoefficients(_CoefficientSet):
    kind = "rate"

    @classmethod
    def read(cls, rc_file_names, dependences=None):
        from .parsers import read_dependences, read_rate_coefficients

        if dependences is None:
            dependences = read_dependences(rc_file_names)
        kxs, kys = read_rate_coefficients(rc_file_names, dependences)
        return cls([Coefficient(d, kx, ky, kind="rate")
                    for d, kx, ky in zip(dependences, kxs, kys)])
