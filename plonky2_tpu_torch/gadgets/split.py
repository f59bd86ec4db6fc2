"""Bit decomposition, range checks, exponentiation and random access on
targets (the port's copy of plonky2_tpu/gadgets/split.py; reference
plonky2/src/gadgets/{split_base,split_join,range_check,arithmetic,
random_access}.rs).

A bit is a plain Target that the gate producing it (a BaseSumGate<2> limb,
a constant) holds to {0, 1}; there is no BoolTarget type.
"""
from __future__ import annotations

from typing import List, Tuple

from ..field import goldilocks as gl
from ..gates.advanced import (BaseSumGate, ExponentiationGate,
                              RandomAccessGate)
from ..iop.generator import SimpleGenerator
from ..iop.target import Target


class WireSplitGenerator(SimpleGenerator):
    """The sums of the BaseSum<2> rows of a split over several gates
    (reference split_join.rs:86-123)."""

    def __init__(self, integer: Target, gate_rows: List[int],
                 num_limbs: int):
        self.integer = integer
        self.gate_rows = gate_rows
        self.num_limbs = num_limbs

    def dependencies(self):
        return [self.integer]

    def run_once(self, witness, out):
        v = witness.get_target(self.integer)
        for row in self.gate_rows:
            if self.num_limbs < 64:
                trunc = v & ((1 << self.num_limbs) - 1)
                v >>= self.num_limbs
            else:
                trunc, v = v, 0
            out.append((("w", row, BaseSumGate.WIRE_SUM), trunc))
        if v:
            raise ValueError("Integer too large to fit in BaseSum gates")


class BaseSumRowGenerator(SimpleGenerator):
    """sum = Σ bits[i] 2^i written into a BaseSum<2> row's sum wire
    (reference split_base.rs:83-105)."""

    def __init__(self, row: int, limbs: List[Target]):
        self.row = row
        self.limbs = limbs

    def dependencies(self):
        return list(self.limbs)

    def run_once(self, witness, out):
        acc = 0
        for t in reversed(self.limbs):
            acc = acc * 2 + witness.get_target(t)
        out.append((("w", self.row, BaseSumGate.WIRE_SUM), acc))


class LowHighGenerator(SimpleGenerator):
    def __init__(self, integer: Target, n_log: int, low: Target,
                 high: Target):
        self.integer = integer
        self.n_log = n_log
        self.low = low
        self.high = high

    def dependencies(self):
        return [self.integer]

    def run_once(self, witness, out):
        v = witness.get_target(self.integer)
        out.append((self.low, v & ((1 << self.n_log) - 1)))
        out.append((self.high, v >> self.n_log))


class EqualityGenerator(SimpleGenerator):
    def __init__(self, x: Target, y: Target, equal: Target, inv: Target):
        self.x = x
        self.y = y
        self.equal = equal
        self.inv = inv

    def dependencies(self):
        return [self.x, self.y]

    def run_once(self, witness, out):
        x = witness.get_target(self.x)
        y = witness.get_target(self.y)
        inv = pow((x - y) % gl.P, gl.P - 2, gl.P) if x != y else 0
        out.append((self.equal, 1 if x == y else 0))
        out.append((self.inv, inv))


class SplitGadgets:
    """Mixed into CircuitBuilder."""

    # -- base arithmetic sugar shared by the gadgets ----------------------

    def num_base_arithmetic_ops_per_gate(self) -> int:
        from ..gates.basic import ArithmeticGate
        return ArithmeticGate.new_from_config(self.config).n_ops

    def mul_sub(self, x: Target, y: Target, z: Target) -> Target:
        return self.arithmetic(1, gl.P - 1, x, y, z)

    def mul_const_add(self, c: int, x: Target, y: Target) -> Target:
        return self.arithmetic(c, 1, x, self.one(), y)

    def add_many(self, terms) -> Target:
        acc = self.zero()
        for t in terms:
            acc = self.add(acc, t)
        return acc

    def mul_many(self, terms) -> Target:
        acc = self.one()
        for t in terms:
            acc = self.mul(acc, t)
        return acc

    # -- bool helpers ------------------------------------------------------

    def constant_bool(self, b: bool) -> Target:
        return self.one() if b else self.zero()

    def not_(self, b: Target) -> Target:
        return self.sub(self.one(), b)

    def and_(self, b1: Target, b2: Target) -> Target:
        return self.mul(b1, b2)

    def assert_bool(self, b: Target) -> None:
        z = self.mul_sub(b, b, b)
        self.connect(z, self.zero())

    def is_equal(self, x: Target, y: Target) -> Target:
        zero = self.zero()
        equal = self.add_virtual_target()
        inv = self.add_virtual_target()
        not_equal = self.not_(equal)
        self.generators.append(EqualityGenerator(x, y, equal, inv))
        diff = self.sub(x, y)
        self.connect(self.mul(equal, diff), zero)
        diff_normalized = self.mul(diff, inv)
        self.connect(self.sub(diff_normalized, not_equal), zero)
        return equal

    # -- bit splits (reference split_join.rs:18-55) ------------------------

    def split_le(self, integer: Target, num_bits: int) -> List[Target]:
        if num_bits == 0:
            return []
        gate_type = BaseSumGate.new_from_config(self.config, 2)
        k = -(-num_bits // gate_type.num_limbs)
        rows = [self.add_gate(gate_type, []) for _ in range(k)]
        bits: List[Target] = []
        for row in rows:
            for col in gate_type.limbs():
                bits.append(("w", row, col))
        for b in bits[num_bits:]:
            self.assert_zero(b)
        del bits[num_bits:]

        base = pow(2, gate_type.num_limbs, gl.P)
        acc = self.zero()
        for row in reversed(rows):
            acc = self.mul_const_add(base, acc,
                                     ("w", row, BaseSumGate.WIRE_SUM))
        self.connect(acc, integer)
        self.generators.append(
            WireSplitGenerator(integer, rows, gate_type.num_limbs))
        return bits

    def split_le_base(self, x: Target, num_limbs: int,
                      base: int) -> List[Target]:
        gate = BaseSumGate(num_limbs, base)
        row = self.add_gate(gate, [])
        self.connect(x, ("w", row, BaseSumGate.WIRE_SUM))
        return [("w", row, c) for c in gate.limbs()]

    def low_bits(self, x: Target, num_low_bits: int,
                 num_bits: int) -> List[Target]:
        return self.split_le(x, num_bits)[:num_low_bits]

    def range_check(self, x: Target, n_log: int) -> None:
        self.split_le(x, n_log)

    def assert_leading_zeros(self, x: Target, leading_zeros: int) -> None:
        self.range_check(x, 64 - leading_zeros)

    def split_low_high(self, x: Target, n_log: int,
                       num_bits: int) -> Tuple[Target, Target]:
        low = self.add_virtual_target()
        high = self.add_virtual_target()
        self.generators.append(LowHighGenerator(x, n_log, low, high))
        self.range_check(low, n_log)
        self.range_check(high, num_bits - n_log)
        comp = self.mul_const_add(1 << n_log, high, low)
        self.connect(x, comp)
        return low, high

    def le_sum(self, bits: List[Target]) -> Target:
        """Σ bits[i] 2^i (reference split_base.rs:36-79)."""
        num_bits = len(bits)
        if num_bits >= 64:
            raise ValueError(f"{num_bits} bits may overflow the field")
        if num_bits == 0:
            return self.zero()
        if num_bits - 1 <= self.num_base_arithmetic_ops_per_gate():
            two = self.two()
            acc = bits[-1]
            for b in reversed(bits[:-1]):
                acc = self.mul_add(two, acc, b)
            return acc
        gate_type = BaseSumGate.new_from_config(self.config, 2)
        row = self.add_gate(gate_type, [])
        for b, col in zip(bits, gate_type.limbs()):
            self.connect(b, ("w", row, col))
        for col in list(gate_type.limbs())[num_bits:]:
            self.assert_zero(("w", row, col))
        self.generators.append(BaseSumRowGenerator(row, list(bits)))
        return ("w", row, BaseSumGate.WIRE_SUM)

    # -- exponentiation (reference gadgets/arithmetic.rs:224-315) ----------

    def exp_power_of_2(self, base: Target, power_log: int) -> Target:
        if power_log > self.num_base_arithmetic_ops_per_gate():
            return self.exp_u64(base, 1 << power_log)
        product = base
        for _ in range(power_log):
            product = self.mul(product, product)
        return product

    def exp_from_bits(self, base: Target,
                      exponent_bits: List[Target]) -> Target:
        gate = ExponentiationGate.new_from_config(self.config)
        bits = list(exponent_bits)
        while len(bits) < gate.num_power_bits:
            bits.append(self.zero())
        row = self.add_gate(gate, [])
        self.connect(base, ("w", row, gate.wire_base()))
        for i, bit in enumerate(bits):
            self.connect(bit, ("w", row, gate.wire_power_bit(i)))
        return ("w", row, gate.wire_output())

    def exp_from_bits_const_base(self, base: int,
                                 exponent_bits: List[Target]) -> Target:
        bits = list(exponent_bits)
        if len(bits) > self.num_base_arithmetic_ops_per_gate():
            return self.exp_from_bits(self.constant(base), bits)
        product = self.one()
        for i, bit in enumerate(bits):
            # product *= 1 + bit (base^(2^i) - 1)
            c = (pow(base, 1 << i, gl.P) - 1) % gl.P
            product = self.arithmetic(c, 1, product, bit, product)
        return product

    def exp_u64(self, base: Target, exponent: int) -> Target:
        bits = []
        while exponent:
            bits.append(self.constant_bool(exponent & 1 == 1))
            exponent >>= 1
        return self.exp_from_bits(base, bits)

    # -- random access (reference gadgets/random_access.rs) ----------------

    def random_access(self, access_index: Target, v: List[Target]) -> Target:
        from ..utils.bits import log2_strict
        vec_size = len(v)
        bits = log2_strict(vec_size)
        if vec_size == 1:
            return v[0]
        claimed = self.add_virtual_target()
        gate = RandomAccessGate.new_from_config(self.config, bits)
        row, copy = self.find_slot(gate, [], [])
        for i, val in enumerate(v):
            self.connect(val, ("w", row, gate.wire_list_item(i, copy)))
        self.connect(access_index, ("w", row, gate.wire_access_index(copy)))
        self.connect(claimed, ("w", row, gate.wire_claimed_element(copy)))
        return claimed

    def random_access_extension(self, access_index: Target, v: list):
        return tuple(
            self.random_access(access_index, [et[i] for et in v])
            for i in range(2))
