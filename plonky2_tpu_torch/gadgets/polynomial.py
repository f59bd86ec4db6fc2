"""Polynomials with extension-target coefficients, evaluated in the
circuit (the port's copy of plonky2_tpu/gadgets/polynomial.py; reference
plonky2/src/gadgets/polynomial.rs)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..iop.target import Target
from .extension import ExtensionTarget
from .reducing import ReducingFactorTarget


@dataclass
class PolynomialCoeffsExtTarget:
    coeffs: List[ExtensionTarget]

    def __len__(self):
        return len(self.coeffs)

    def eval_scalar(self, builder, point: Target) -> ExtensionTarget:
        p = ReducingFactorTarget(builder.convert_to_ext(point))
        return p.reduce(self.coeffs, builder)

    def eval(self, builder, point: ExtensionTarget) -> ExtensionTarget:
        p = ReducingFactorTarget(point)
        return p.reduce(self.coeffs, builder)
