"""QField: quadrature-point scalar fields carrying their spatial gradient
(the JAX package's `model/qfield.py`).

Forms like grad(D_si * exp(u)), where D_si is itself an expression of
several P1 fields (the semi-implicit coefficients), expand by the chain
rule over every interpolated factor. A QField is a dual number over space:
(value, gradient) at each quadrature point, with arithmetic that propagates
the gradient. Everything stays torch arithmetic, so forward-mode AD
differentiates through it in the state direction as well.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class QField:
    val: torch.Tensor   # [n_cells, n_q]
    grad: torch.Tensor  # [n_cells, n_q, dim]

    @staticmethod
    def from_nodal(batch, field_e: torch.Tensor) -> "QField":
        """From gathered nodal values [n_cells/facets, n_local]."""
        return QField(batch.value(field_e), batch.grad(field_e))

    @staticmethod
    def const(c, like: "QField") -> "QField":
        # a number, filled in on the device: nothing is copied from the host
        return QField(torch.full_like(like.val, c),
                      torch.zeros_like(like.grad))

    def _coerce(self, other) -> "QField":
        if isinstance(other, QField):
            return other
        return QField.const(other, self)

    def __add__(self, other):
        o = self._coerce(other)
        return QField(self.val + o.val, self.grad + o.grad)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._coerce(other)
        return QField(self.val - o.val, self.grad - o.grad)

    def __rsub__(self, other):
        o = self._coerce(other)
        return QField(o.val - self.val, o.grad - self.grad)

    def __mul__(self, other):
        o = self._coerce(other)
        return QField(self.val * o.val,
                      self.grad * o.val[..., None]
                      + o.grad * self.val[..., None])

    __rmul__ = __mul__

    def __truediv__(self, other):
        o = self._coerce(other)
        val = self.val / o.val
        grad = (self.grad * o.val[..., None]
                - o.grad * self.val[..., None]) / (o.val * o.val)[..., None]
        return QField(val, grad)

    def __rtruediv__(self, other):
        return self._coerce(other).__truediv__(self)

    def __neg__(self):
        return QField(-self.val, -self.grad)

    def exp(self) -> "QField":
        e = torch.exp(self.val)
        return QField(e, e[..., None] * self.grad)
