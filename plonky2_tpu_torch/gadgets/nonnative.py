"""Arithmetic in a foreign field over u32-limb big integers: the port's
copy of plonky2_tpu/gadgets/nonnative.py (reference ecdsa/src/gadgets/
nonnative.rs).

A ``NonNativeTarget`` is a BigUintTarget with the foreign field's modulus
(a Python int), the reference's type parameter ``FF``.  Each result is
reduced by a quotient that a generator computes and that limb arithmetic
over Goldilocks constrains.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from .biguint import (BigUintTarget, emit_biguint, get_biguint,
                      set_biguint_target)


@dataclass
class NonNativeTarget:
    value: BigUintTarget
    modulus: int

    def num_limbs(self) -> int:
        return self.value.num_limbs()


def num_nonnative_limbs(modulus: int) -> int:
    return -(-modulus.bit_length() // 32)


def set_nonnative_target(pw, target: NonNativeTarget, value: int) -> None:
    set_biguint_target(pw, target.value, value % target.modulus)


def _reduced(witness, target: NonNativeTarget) -> int:
    return get_biguint(witness, target.value) % target.modulus


class _NonNativeAddGenerator(SimpleGenerator):
    def __init__(self, a, b, s, overflow):
        self.a, self.b, self.s, self.overflow = a, b, s, overflow

    def dependencies(self):
        return list(self.a.value.limbs) + list(self.b.value.limbs)

    def run_once(self, witness, out):
        m = self.a.modulus
        total = _reduced(witness, self.a) + _reduced(witness, self.b)
        overflow = 1 if total > m else 0
        emit_biguint(out, self.s.value, total - overflow * m)
        out.append((self.overflow, overflow))


class _NonNativeMultipleAddsGenerator(SimpleGenerator):
    def __init__(self, summands, s, overflow):
        self.summands, self.s, self.overflow = summands, s, overflow

    def dependencies(self):
        return [limb for t in self.summands for limb in t.value.limbs]

    def run_once(self, witness, out):
        total = sum(_reduced(witness, t) for t in self.summands)
        overflow, reduced = divmod(total, self.s.modulus)
        emit_biguint(out, self.s.value, reduced)
        out.append((self.overflow, overflow))


class _NonNativeSubGenerator(SimpleGenerator):
    def __init__(self, a, b, diff, overflow):
        self.a, self.b, self.diff, self.overflow = a, b, diff, overflow

    def dependencies(self):
        return list(self.a.value.limbs) + list(self.b.value.limbs)

    def run_once(self, witness, out):
        a, b = _reduced(witness, self.a), _reduced(witness, self.b)
        if a >= b:
            diff, overflow = a - b, 0
        else:
            diff, overflow = self.a.modulus + a - b, 1
        emit_biguint(out, self.diff.value, diff)
        out.append((self.overflow, overflow))


class _NonNativeMulGenerator(SimpleGenerator):
    def __init__(self, a, b, prod, overflow):
        self.a, self.b, self.prod, self.overflow = a, b, prod, overflow

    def dependencies(self):
        return list(self.a.value.limbs) + list(self.b.value.limbs)

    def run_once(self, witness, out):
        overflow, reduced = divmod(
            _reduced(witness, self.a) * _reduced(witness, self.b),
            self.a.modulus)
        emit_biguint(out, self.prod.value, reduced)
        emit_biguint(out, self.overflow, overflow)


class _NonNativeInverseGenerator(SimpleGenerator):
    def __init__(self, x, inv, div):
        self.x, self.inv, self.div = x, inv, div

    def dependencies(self):
        return list(self.x.value.limbs)

    def run_once(self, witness, out):
        m = self.x.modulus
        x = _reduced(witness, self.x)
        inv = pow(x, -1, m)
        emit_biguint(out, self.div, x * inv // m)
        emit_biguint(out, self.inv, inv)


class NonNativeGadgets:
    """Mixed into CircuitBuilder."""

    def biguint_to_nonnative(self, x: BigUintTarget,
                             modulus: int) -> NonNativeTarget:
        return NonNativeTarget(value=x, modulus=modulus)

    def constant_nonnative(self, x: int, modulus: int) -> NonNativeTarget:
        return self.biguint_to_nonnative(self.constant_biguint(x % modulus),
                                         modulus)

    def zero_nonnative(self, modulus: int) -> NonNativeTarget:
        return self.constant_nonnative(0, modulus)

    def connect_nonnative(self, lhs: NonNativeTarget,
                          rhs: NonNativeTarget) -> None:
        self.connect_biguint(lhs.value, rhs.value)

    def add_virtual_nonnative_target(self, modulus: int) -> NonNativeTarget:
        return NonNativeTarget(
            value=self.add_virtual_biguint_target(
                num_nonnative_limbs(modulus)),
            modulus=modulus)

    def _same_field(self, a: NonNativeTarget, b: NonNativeTarget) -> None:
        if a.modulus != b.modulus:
            raise ValueError("operands of two fields")

    def add_nonnative(self, a: NonNativeTarget,
                      b: NonNativeTarget) -> NonNativeTarget:
        self._same_field(a, b)
        s = self.add_virtual_nonnative_target(a.modulus)
        overflow = self.add_virtual_target()
        self.generators.append(_NonNativeAddGenerator(a, b, s, overflow))
        self.assert_bool(overflow)

        sum_expected = self.add_biguint(a.value, b.value)
        modulus = self.constant_biguint(a.modulus)
        mod_times_overflow = self.mul_biguint_by_bool(modulus, overflow)
        sum_actual = self.add_biguint(s.value, mod_times_overflow)
        self.connect_biguint(sum_expected, sum_actual)
        # cmp_biguint's ComparisonGate range-checks its inputs
        self.assert_one(self.cmp_biguint(s.value, modulus))
        return s

    def add_many_nonnative(self,
                           to_add: List[NonNativeTarget]) -> NonNativeTarget:
        if len(to_add) == 1:
            return to_add[0]
        modulus_int = to_add[0].modulus
        s = self.add_virtual_nonnative_target(modulus_int)
        overflow = self.add_virtual_u32_target()
        self.generators.append(
            _NonNativeMultipleAddsGenerator(list(to_add), s, overflow))
        self.range_check_u32(s.value.limbs)
        self.range_check_u32([overflow])

        sum_expected = self.zero_biguint()
        for t in to_add:
            sum_expected = self.add_biguint(sum_expected, t.value)
        modulus = self.constant_biguint(modulus_int)
        mod_times_overflow = self.mul_biguint(modulus,
                                              BigUintTarget([overflow]))
        sum_actual = self.add_biguint(s.value, mod_times_overflow)
        self.connect_biguint(sum_expected, sum_actual)
        self.assert_one(self.cmp_biguint(s.value, modulus))
        return s

    def sub_nonnative(self, a: NonNativeTarget,
                      b: NonNativeTarget) -> NonNativeTarget:
        self._same_field(a, b)
        diff = self.add_virtual_nonnative_target(a.modulus)
        overflow = self.add_virtual_target()
        self.generators.append(_NonNativeSubGenerator(a, b, diff, overflow))
        self.range_check_u32(diff.value.limbs)
        self.assert_bool(overflow)

        diff_plus_b = self.add_biguint(diff.value, b.value)
        modulus = self.constant_biguint(a.modulus)
        mod_times_overflow = self.mul_biguint_by_bool(modulus, overflow)
        diff_plus_b_reduced = self.sub_biguint(diff_plus_b, mod_times_overflow)
        self.connect_biguint(a.value, diff_plus_b_reduced)
        return diff

    def mul_nonnative(self, a: NonNativeTarget,
                      b: NonNativeTarget) -> NonNativeTarget:
        self._same_field(a, b)
        prod = self.add_virtual_nonnative_target(a.modulus)
        modulus = self.constant_biguint(a.modulus)
        overflow = self.add_virtual_biguint_target(
            a.value.num_limbs() + b.value.num_limbs() - modulus.num_limbs())
        self.generators.append(_NonNativeMulGenerator(a, b, prod, overflow))
        self.range_check_u32(prod.value.limbs)
        self.range_check_u32(overflow.limbs)

        prod_expected = self.mul_biguint(a.value, b.value)
        mod_times_overflow = self.mul_biguint(modulus, overflow)
        prod_actual = self.add_biguint(prod.value, mod_times_overflow)
        self.connect_biguint(prod_expected, prod_actual)
        return prod

    def mul_many_nonnative(self,
                           to_mul: List[NonNativeTarget]) -> NonNativeTarget:
        acc = to_mul[0]
        for t in to_mul[1:]:
            acc = self.mul_nonnative(acc, t)
        return acc

    def neg_nonnative(self, x: NonNativeTarget) -> NonNativeTarget:
        zero = self.biguint_to_nonnative(self.zero_biguint(), x.modulus)
        return self.sub_nonnative(zero, x)

    def inv_nonnative(self, x: NonNativeTarget) -> NonNativeTarget:
        num_limbs = x.value.num_limbs()
        inv = self.add_virtual_biguint_target(num_limbs)
        div = self.add_virtual_biguint_target(num_limbs)
        self.generators.append(_NonNativeInverseGenerator(x, inv, div))
        self.range_check_u32(inv.limbs)
        self.range_check_u32(div.limbs)

        product = self.mul_biguint(x.value, inv)
        modulus = self.constant_biguint(x.modulus)
        mod_times_div = self.mul_biguint(modulus, div)
        one = self.constant_biguint(1)
        expected = self.add_biguint(mod_times_div, one)
        self.connect_biguint(product, expected)
        return NonNativeTarget(value=inv, modulus=x.modulus)

    def div_nonnative(self, x: NonNativeTarget,
                      y: NonNativeTarget) -> NonNativeTarget:
        return self.mul_nonnative(x, self.inv_nonnative(y))

    def mul_nonnative_by_bool(self, a: NonNativeTarget,
                              b: Target) -> NonNativeTarget:
        return NonNativeTarget(value=self.mul_biguint_by_bool(a.value, b),
                               modulus=a.modulus)

    def if_nonnative(self, b: Target, x: NonNativeTarget,
                     y: NonNativeTarget) -> NonNativeTarget:
        not_b = self.not_(b)
        maybe_x = self.mul_nonnative_by_bool(x, b)
        maybe_y = self.mul_nonnative_by_bool(y, not_b)
        return self.add_nonnative(maybe_x, maybe_y)

    def reduce(self, x: BigUintTarget, modulus: int) -> NonNativeTarget:
        order = self.constant_biguint(modulus)
        return NonNativeTarget(value=self.rem_biguint(x, order),
                               modulus=modulus)

    def reduce_nonnative(self, x: NonNativeTarget) -> NonNativeTarget:
        return self.reduce(x.value, x.modulus)

    def bool_to_nonnative(self, b: Target, modulus: int) -> NonNativeTarget:
        return NonNativeTarget(value=BigUintTarget([b]), modulus=modulus)

    def split_nonnative_to_bits(self, x: NonNativeTarget) -> List[Target]:
        bits = []
        for limb in x.value.limbs:
            bits.extend(self.split_le_base(limb, 32, 2))
        return bits

    def nonnative_conditional_neg(self, x: NonNativeTarget,
                                  b: Target) -> NonNativeTarget:
        not_b = self.not_(b)
        neg = self.neg_nonnative(x)
        x_if_true = self.mul_nonnative_by_bool(neg, b)
        x_if_false = self.mul_nonnative_by_bool(x, not_b)
        return self.add_nonnative(x_if_true, x_if_false)
