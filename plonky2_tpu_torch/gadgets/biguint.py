"""Unsigned integers of any size over u32 limb targets: the port's copy of
plonky2_tpu/gadgets/biguint.py (reference ecdsa/src/gadgets/biguint.rs).

Values are Python ints; a ``BigUintTarget`` is a little-endian list of
u32 limb targets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..iop.generator import SimpleGenerator
from ..iop.target import Target


def to_u32_digits(value: int) -> List[int]:
    """The little-endian u32 limbs of `value`, none for 0."""
    if value < 0:
        raise ValueError(f"{value} is negative")
    limbs = []
    while value:
        limbs.append(value & 0xFFFFFFFF)
        value >>= 32
    return limbs


@dataclass
class BigUintTarget:
    limbs: List[Target]

    def num_limbs(self) -> int:
        return len(self.limbs)

    def get_limb(self, i: int) -> Target:
        return self.limbs[i]


class BigUintDivRemGenerator(SimpleGenerator):
    def __init__(self, a: BigUintTarget, b: BigUintTarget,
                 div: BigUintTarget, rem: BigUintTarget):
        self.a = a
        self.b = b
        self.div = div
        self.rem = rem

    def dependencies(self):
        return list(self.a.limbs) + list(self.b.limbs)

    def run_once(self, witness, out):
        div, rem = divmod(get_biguint(witness, self.a),
                          get_biguint(witness, self.b))
        emit_biguint(out, self.div, div)
        emit_biguint(out, self.rem, rem)


def get_biguint(witness, target: BigUintTarget) -> int:
    acc = 0
    for limb in reversed(target.limbs):
        acc = (acc << 32) + witness.get_target(limb)
    return acc


def _padded_limbs(target: BigUintTarget, value: int) -> List[int]:
    limbs = to_u32_digits(value)
    if len(limbs) > target.num_limbs():
        raise ValueError(f"{value:#x} does not fit {target.num_limbs()} "
                         f"limbs")
    return limbs + [0] * (target.num_limbs() - len(limbs))


def set_biguint_target(pw, target: BigUintTarget, value: int) -> None:
    for t, v in zip(target.limbs, _padded_limbs(target, value)):
        pw.set_target(t, v)


def emit_biguint(out, target: BigUintTarget, value: int) -> None:
    """A generator's outputs: `value`'s limbs into `target`'s."""
    out.extend(zip(target.limbs, _padded_limbs(target, value)))


class BigUintGadgets:
    """Mixed into CircuitBuilder."""

    def constant_biguint(self, value: int) -> BigUintTarget:
        return BigUintTarget([self.constant_u32(limb)
                              for limb in to_u32_digits(value)])

    def zero_biguint(self) -> BigUintTarget:
        return BigUintTarget([])

    def connect_biguint(self, lhs: BigUintTarget, rhs: BigUintTarget) -> None:
        n = min(lhs.num_limbs(), rhs.num_limbs())
        for i in range(n):
            self.connect_u32(lhs.limbs[i], rhs.limbs[i])
        for i in range(n, lhs.num_limbs()):
            self.assert_zero_u32(lhs.limbs[i])
        for i in range(n, rhs.num_limbs()):
            self.assert_zero_u32(rhs.limbs[i])

    def pad_biguints(self, a: BigUintTarget,
                     b: BigUintTarget) -> Tuple[BigUintTarget, BigUintTarget]:
        n = max(a.num_limbs(), b.num_limbs())
        zero = self.zero_u32()
        pa = BigUintTarget(list(a.limbs) + [zero] * (n - a.num_limbs()))
        pb = BigUintTarget(list(b.limbs) + [zero] * (n - b.num_limbs()))
        return pa, pb

    def cmp_biguint(self, a: BigUintTarget, b: BigUintTarget) -> Target:
        """1 if a <= b."""
        a, b = self.pad_biguints(a, b)
        return self.list_le_u32(a.limbs, b.limbs)

    def add_virtual_biguint_target(self, num_limbs: int) -> BigUintTarget:
        return BigUintTarget(self.add_virtual_u32_targets(num_limbs))

    def add_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
        num_limbs = max(a.num_limbs(), b.num_limbs())
        zero = self.zero_u32()
        combined = []
        carry = zero
        for i in range(num_limbs):
            a_limb = a.limbs[i] if i < a.num_limbs() else zero
            b_limb = b.limbs[i] if i < b.num_limbs() else zero
            new_limb, carry = self.add_many_u32([carry, a_limb, b_limb])
            combined.append(new_limb)
        combined.append(carry)
        return BigUintTarget(combined)

    def sub_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
        """a - b, for a >= b."""
        a, b = self.pad_biguints(a, b)
        result = []
        borrow = self.zero_u32()
        for x, y in zip(a.limbs, b.limbs):
            r, borrow = self.sub_u32(x, y, borrow)
            result.append(r)
        return BigUintTarget(result)

    def mul_biguint(self, a: BigUintTarget, b: BigUintTarget) -> BigUintTarget:
        total = a.num_limbs() + b.num_limbs()
        to_add = [[] for _ in range(total)]
        for i, ai in enumerate(a.limbs):
            for j, bj in enumerate(b.limbs):
                product, carry = self.mul_u32(ai, bj)
                to_add[i + j].append(product)
                to_add[i + j + 1].append(carry)
        combined = []
        carry = self.zero_u32()
        for summands in to_add:
            new_result, carry = self.add_u32s_with_carry(summands, carry)
            combined.append(new_result)
        combined.append(carry)
        return BigUintTarget(combined)

    def mul_biguint_by_bool(self, a: BigUintTarget,
                            b: Target) -> BigUintTarget:
        return BigUintTarget([self.mul(limb, b) for limb in a.limbs])

    def mul_add_biguint(self, x, y, z) -> BigUintTarget:
        return self.add_biguint(self.mul_biguint(x, y), z)

    def div_rem_biguint(self, a: BigUintTarget,
                        b: BigUintTarget
                        ) -> Tuple[BigUintTarget, BigUintTarget]:
        a_len, b_len = a.num_limbs(), b.num_limbs()
        div_num_limbs = 0 if b_len > a_len + 1 else a_len - b_len + 1
        div = self.add_virtual_biguint_target(div_num_limbs)
        rem = self.add_virtual_biguint_target(b_len)
        self.generators.append(BigUintDivRemGenerator(a, b, div, rem))
        div_b = self.mul_biguint(div, b)
        div_b_plus_rem = self.add_biguint(div_b, rem)
        self.connect_biguint(a, div_b_plus_rem)
        self.assert_one(self.cmp_biguint(rem, b))
        return div, rem

    def div_biguint(self, a, b) -> BigUintTarget:
        return self.div_rem_biguint(a, b)[0]

    def rem_biguint(self, a, b) -> BigUintTarget:
        return self.div_rem_biguint(a, b)[1]
