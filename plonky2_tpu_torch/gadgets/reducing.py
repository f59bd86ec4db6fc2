"""Alpha-reduction of targets through the Reducing gates (the port's copy
of plonky2_tpu/gadgets/reducing.py; reference
plonky2/src/util/reducing.rs:113-273)."""
from __future__ import annotations

from typing import List

from ..gates.advanced import (ArithmeticExtensionGate, ReducingExtensionGate,
                              ReducingGate)
from ..iop.target import Target
from .extension import ExtensionTarget, ext_from_range


def _arithmetic_ops(builder) -> int:
    return ArithmeticExtensionGate.new_from_config(builder.config).n_ops


class ReducingFactorTarget:
    def __init__(self, base: ExtensionTarget):
        self.base = base
        self.count = 0

    def reduce_base(self, terms: List[Target], builder) -> ExtensionTarget:
        l = len(terms)
        if l <= _arithmetic_ops(builder) + 1:
            terms_ext = [builder.convert_to_ext(t) for t in terms]
            return self._reduce_arithmetic(terms_ext, builder)

        max_coeffs_len = ReducingGate.max_coeffs_len(
            builder.config.num_wires, builder.config.num_routed_wires)
        self.count += l
        zero = builder.zero()
        acc = builder.zero_extension()
        reversed_terms = list(terms)
        while len(reversed_terms) % max_coeffs_len != 0:
            reversed_terms.append(zero)
        reversed_terms.reverse()
        for start in range(0, len(reversed_terms), max_coeffs_len):
            chunk = reversed_terms[start:start + max_coeffs_len]
            gate = ReducingGate(max_coeffs_len)
            row = builder.add_gate(gate, [])
            builder.connect_extension(
                self.base, ext_from_range(row, gate.wires_alpha()))
            builder.connect_extension(
                acc, ext_from_range(row, gate.wires_old_acc()))
            for t, c in zip(chunk, gate.wires_coeffs()):
                builder.connect(t, ("w", row, c))
            acc = ext_from_range(row, gate.wires_output())
        return acc

    def reduce(self, terms: List[ExtensionTarget], builder) -> ExtensionTarget:
        l = len(terms)
        if l <= _arithmetic_ops(builder) + 1:
            return self._reduce_arithmetic(terms, builder)

        max_coeffs_len = ReducingExtensionGate.max_coeffs_len(
            builder.config.num_wires, builder.config.num_routed_wires)
        self.count += l
        zero_ext = builder.zero_extension()
        acc = zero_ext
        reversed_terms = list(terms)
        while len(reversed_terms) % max_coeffs_len != 0:
            reversed_terms.append(zero_ext)
        reversed_terms.reverse()
        for start in range(0, len(reversed_terms), max_coeffs_len):
            chunk = reversed_terms[start:start + max_coeffs_len]
            gate = ReducingExtensionGate(max_coeffs_len)
            row = builder.add_gate(gate, [])
            builder.connect_extension(
                self.base, ext_from_range(row, gate.wires_alpha()))
            builder.connect_extension(
                acc, ext_from_range(row, gate.wires_old_acc()))
            for i, t in enumerate(chunk):
                builder.connect_extension(
                    t, ext_from_range(row, gate.wires_coeff(i)))
            acc = ext_from_range(row, gate.wires_output())
        return acc

    def _reduce_arithmetic(self, terms: List[ExtensionTarget],
                           builder) -> ExtensionTarget:
        self.count += len(terms)
        acc = builder.zero_extension()
        for et in reversed(terms):
            acc = builder.mul_add_extension(self.base, acc, et)
        return acc

    def shift(self, x: ExtensionTarget, builder) -> ExtensionTarget:
        if x == builder.zero_extension():
            exp = builder.zero_extension()
        else:
            exp = builder.exp_u64_extension(self.base, self.count)
        self.count = 0
        return builder.mul_extension(exp, x)
