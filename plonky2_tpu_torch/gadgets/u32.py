"""The u32 arithmetic gadgets (the port's copy of plonky2_tpu/gadgets/u32.py;
reference u32/src/gadgets/{arithmetic_u32,multiple_comparison,
range_check}.rs).

A ``U32Target`` is a plain Target whose value is maintained in [0, 2^32) by
the producing gates; there is no wrapper type.  All u32 ops return
(low, high) pairs of 32-bit halves.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..field import goldilocks as gl
from ..gates.u32_gates import (ComparisonGate, U32AddManyGate,
                               U32ArithmeticGate, U32RangeCheckGate,
                               U32SubtractionGate)
from ..iop.target import Target

U32Target = Target


class U32Gadgets:
    """Mixed into CircuitBuilder."""

    def add_virtual_u32_target(self) -> U32Target:
        return self.add_virtual_target()

    def add_virtual_u32_targets(self, n: int) -> List[U32Target]:
        return self.add_virtual_targets(n)

    def constant_u32(self, c: int) -> U32Target:
        if not 0 <= c < 1 << 32:
            raise ValueError(f"{c} is not a u32")
        return self.constant(c)

    def zero_u32(self) -> U32Target:
        return self.zero()

    def one_u32(self) -> U32Target:
        return self.one()

    def connect_u32(self, x: U32Target, y: U32Target) -> None:
        self.connect(x, y)

    def assert_zero_u32(self, x: U32Target) -> None:
        self.assert_zero(x)

    def _arithmetic_u32_special_cases(self, x, y, z) -> Optional[Tuple]:
        xc = self.target_as_constant(x)
        yc = self.target_as_constant(y)
        zc = self.target_as_constant(z)
        if xc is not None and yc is not None and zc is not None:
            s = xc * yc + zc
            return (self.constant_u32(s & 0xFFFFFFFF),
                    self.constant_u32(s >> 32))
        return None

    def mul_add_u32(self, x: U32Target, y: U32Target,
                    z: U32Target) -> Tuple[U32Target, U32Target]:
        """x * y + z as (low, high) 32-bit halves."""
        special = self._arithmetic_u32_special_cases(x, y, z)
        if special is not None:
            return special
        gate = U32ArithmeticGate.new_from_config(self.config)
        row, copy = self.find_slot(gate, [], [])
        self.connect(("w", row, gate.wire_ith_multiplicand_0(copy)), x)
        self.connect(("w", row, gate.wire_ith_multiplicand_1(copy)), y)
        self.connect(("w", row, gate.wire_ith_addend(copy)), z)
        return (("w", row, gate.wire_ith_output_low_half(copy)),
                ("w", row, gate.wire_ith_output_high_half(copy)))

    def add_u32(self, a: U32Target,
                b: U32Target) -> Tuple[U32Target, U32Target]:
        return self.mul_add_u32(a, self.one_u32(), b)

    def mul_u32(self, a: U32Target,
                b: U32Target) -> Tuple[U32Target, U32Target]:
        return self.mul_add_u32(a, b, self.zero_u32())

    def add_many_u32(self, to_add: List[U32Target]
                     ) -> Tuple[U32Target, U32Target]:
        if len(to_add) == 0:
            return self.zero_u32(), self.zero_u32()
        if len(to_add) == 1:
            return to_add[0], self.zero_u32()
        if len(to_add) == 2:
            return self.add_u32(to_add[0], to_add[1])
        return self.add_u32s_with_carry(to_add, self.zero_u32())

    def add_u32s_with_carry(self, to_add: List[U32Target],
                            carry: U32Target) -> Tuple[U32Target, U32Target]:
        if len(to_add) == 1:
            return self.add_u32(to_add[0], carry)
        num_addends = len(to_add)
        gate = U32AddManyGate.new_from_config(self.config, num_addends)
        row, copy = self.find_slot(gate, [num_addends], [])
        for j, t in enumerate(to_add):
            self.connect(("w", row, gate.wire_ith_op_jth_addend(copy, j)), t)
        self.connect(("w", row, gate.wire_ith_carry(copy)), carry)
        return (("w", row, gate.wire_ith_output_result(copy)),
                ("w", row, gate.wire_ith_output_carry(copy)))

    def sub_u32(self, x: U32Target, y: U32Target,
                borrow: U32Target) -> Tuple[U32Target, U32Target]:
        """x - y - borrow as (result, borrow_out), borrow_out in {0,1}."""
        gate = U32SubtractionGate.new_from_config(self.config)
        row, copy = self.find_slot(gate, [], [])
        self.connect(("w", row, gate.wire_ith_input_x(copy)), x)
        self.connect(("w", row, gate.wire_ith_input_y(copy)), y)
        self.connect(("w", row, gate.wire_ith_input_borrow(copy)), borrow)
        return (("w", row, gate.wire_ith_output_result(copy)),
                ("w", row, gate.wire_ith_output_borrow(copy)))

    def range_check_u32(self, vals: List[U32Target]) -> None:
        gate = U32RangeCheckGate(len(vals))
        row = self.add_gate(gate, [])
        for i, v in enumerate(vals):
            self.connect(("w", row, gate.wire_ith_input_limb(i)), v)

    # -- list comparison (reference multiple_comparison.rs) -----------------

    def list_le(self, a: List[Target], b: List[Target],
                num_bits: int) -> Target:
        """1 if a <= b as little-endian base-2^num_bits limb lists
        (range-checks inputs)."""
        if len(a) != len(b):
            raise ValueError("list_le compares lists of one length")
        chunk_bits = 2
        num_chunks = -(-num_bits // chunk_bits)
        one = self.one()
        result = one
        for ai, bi in zip(a, b):
            a_le_b_gate = ComparisonGate(num_bits, num_chunks)
            a_le_b_row = self.add_gate(a_le_b_gate, [])
            self.connect(("w", a_le_b_row, a_le_b_gate.wire_first_input()), ai)
            self.connect(("w", a_le_b_row, a_le_b_gate.wire_second_input()),
                         bi)
            a_le_b = ("w", a_le_b_row, a_le_b_gate.wire_result_bool())

            b_le_a_gate = ComparisonGate(num_bits, num_chunks)
            b_le_a_row = self.add_gate(b_le_a_gate, [])
            self.connect(("w", b_le_a_row, b_le_a_gate.wire_first_input()), bi)
            self.connect(("w", b_le_a_row, b_le_a_gate.wire_second_input()),
                         ai)
            b_le_a = ("w", b_le_a_row, b_le_a_gate.wire_result_bool())

            limbs_equal = self.mul(a_le_b, b_le_a)
            limbs_less_than = self.sub(one, b_le_a)
            result = self.mul_add(limbs_equal, result, limbs_less_than)
        return result

    def list_le_u32(self, a: List[U32Target], b: List[U32Target]) -> Target:
        return self.list_le(a, b, 32)
