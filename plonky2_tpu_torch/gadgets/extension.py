"""Quadratic-extension arithmetic on targets (the port's copy of
plonky2_tpu/gadgets/extension.py; reference
plonky2/src/gadgets/arithmetic_extension.rs, iop/ext_target.rs).

An ``ExtensionTarget`` is a pair of Targets (t0, t1) standing for
t0 + t1 X in GF(p)[X]/(X^2 - 7).  Every operation goes through
``arithmetic_extension``, which folds constants and packs the rest into
ArithmeticExtensionGate or MulExtensionGate slots, as the reference does.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ..field import extension as ge
from ..field import goldilocks as gl
from ..gates.advanced import ArithmeticExtensionGate, MulExtensionGate
from ..iop.generator import SimpleGenerator
from ..iop.target import Target

D = 2
ExtensionTarget = Tuple[Target, Target]


class QuotientGeneratorExtension(SimpleGenerator):
    """quotient = numerator / denominator in the extension field
    (reference gadgets/arithmetic_extension.rs:497-518)."""

    def __init__(self, numerator: ExtensionTarget,
                 denominator: ExtensionTarget, quotient: ExtensionTarget):
        self.numerator = numerator
        self.denominator = denominator
        self.quotient = quotient

    def dependencies(self):
        return list(self.numerator) + list(self.denominator)

    def run_once(self, witness, out):
        num = tuple(witness.get_target(t) for t in self.numerator)
        den = tuple(witness.get_target(t) for t in self.denominator)
        q = ge.s_mul(num, ge.s_inv(den))
        out.append((self.quotient[0], q[0]))
        out.append((self.quotient[1], q[1]))


def ext_from_range(row: int, r: range) -> ExtensionTarget:
    if len(r) != D:
        raise ValueError(f"an extension target takes {D} wires, got {r}")
    return (("w", row, r.start), ("w", row, r.start + 1))


class ExtensionGadgets:
    """Mixed into CircuitBuilder.  Requires: constant, zero, one, connect,
    add_virtual_target, find_slot, generators, targets_to_constants."""

    # -- virtual targets & constants ------------------------------------

    def add_virtual_extension_target(self) -> ExtensionTarget:
        return (self.add_virtual_target(), self.add_virtual_target())

    def add_virtual_extension_targets(self, n: int) -> List[ExtensionTarget]:
        return [self.add_virtual_extension_target() for _ in range(n)]

    def constant_extension(self, c) -> ExtensionTarget:
        c0, c1 = int(c[0]) % gl.P, int(c[1]) % gl.P
        return (self.constant(c0), self.constant(c1))

    def zero_extension(self) -> ExtensionTarget:
        return self.constant_extension((0, 0))

    def one_extension(self) -> ExtensionTarget:
        return self.constant_extension((1, 0))

    def convert_to_ext(self, t: Target) -> ExtensionTarget:
        return (t, self.zero())

    def target_as_constant_ext(self, t: ExtensionTarget) -> Optional[tuple]:
        c0 = self.target_as_constant(t[0])
        c1 = self.target_as_constant(t[1])
        if c0 is None or c1 is None:
            return None
        return (c0, c1)

    def connect_extension(self, a: ExtensionTarget,
                          b: ExtensionTarget) -> None:
        self.connect(a[0], b[0])
        self.connect(a[1], b[1])

    # -- core op (reference arithmetic_extension.rs:18-102) -------------

    def arithmetic_extension(self, const_0: int, const_1: int,
                             m0: ExtensionTarget, m1: ExtensionTarget,
                             addend: ExtensionTarget) -> ExtensionTarget:
        const_0 %= gl.P
        const_1 %= gl.P
        special = self._arithmetic_ext_special_cases(const_0, const_1, m0, m1,
                                                     addend)
        if special is not None:
            return special

        op = (const_0, const_1, m0, m1, addend)
        if op in self.arithmetic_ext_results:
            return self.arithmetic_ext_results[op]

        if self.target_as_constant_ext(addend) == (0, 0):
            result = self._mul_ext_op(const_0, m0, m1)
        else:
            result = self._arithmetic_ext_op(const_0, const_1, m0, m1, addend)
        self.arithmetic_ext_results[op] = result
        return result

    def _arithmetic_ext_op(self, c0, c1, m0, m1, addend) -> ExtensionTarget:
        gate = ArithmeticExtensionGate.new_from_config(self.config)
        consts = [c0, c1]
        g, i = self.find_slot(gate, consts, consts)
        self.connect_extension(m0, ext_from_range(
            g, gate.wires_ith_multiplicand_0(i)))
        self.connect_extension(m1, ext_from_range(
            g, gate.wires_ith_multiplicand_1(i)))
        self.connect_extension(addend, ext_from_range(
            g, gate.wires_ith_addend(i)))
        return ext_from_range(g, gate.wires_ith_output(i))

    def _mul_ext_op(self, c0, m0, m1) -> ExtensionTarget:
        gate = MulExtensionGate.new_from_config(self.config)
        g, i = self.find_slot(gate, [c0], [c0])
        self.connect_extension(m0, ext_from_range(
            g, gate.wires_ith_multiplicand_0(i)))
        self.connect_extension(m1, ext_from_range(
            g, gate.wires_ith_multiplicand_1(i)))
        return ext_from_range(g, gate.wires_ith_output(i))

    def _arithmetic_ext_special_cases(self, c0, c1, m0, m1, addend):
        zero = self.zero_extension()
        m0c = self.target_as_constant_ext(m0)
        m1c = self.target_as_constant_ext(m1)
        adc = self.target_as_constant_ext(addend)
        first_zero = c0 == 0 or m0 == zero or m1 == zero
        second_zero = c1 == 0 or addend == zero
        first_const = (0, 0) if first_zero else (
            ge.s_mul(ge.s_mul(m0c, m1c), (c0, 0))
            if (m0c is not None and m1c is not None) else None)
        second_const = (0, 0) if second_zero else (
            ge.s_mul(adc, (c1, 0)) if adc is not None else None)
        if first_const is not None and second_const is not None:
            return self.constant_extension(ge.s_add(first_const, second_const))
        if first_zero and c1 == 1:
            return addend
        if second_zero:
            if m0c is not None and ge.s_mul(m0c, (c0, 0)) == (1, 0):
                return m1
            if m1c is not None and ge.s_mul(m1c, (c0, 0)) == (1, 0):
                return m0
        return None

    # -- derived ops ------------------------------------------------------

    def add_extension(self, a, b) -> ExtensionTarget:
        one = self.one_extension()
        return self.arithmetic_extension(1, 1, one, a, b)

    def add_many_extension(self, terms) -> ExtensionTarget:
        acc = self.zero_extension()
        for t in terms:
            acc = self.add_extension(acc, t)
        return acc

    def sub_extension(self, a, b) -> ExtensionTarget:
        one = self.one_extension()
        return self.arithmetic_extension(1, gl.P - 1, one, a, b)

    def mul_extension_with_const(self, c0, m0, m1) -> ExtensionTarget:
        zero = self.zero_extension()
        return self.arithmetic_extension(c0, 0, m0, m1, zero)

    def mul_extension(self, a, b) -> ExtensionTarget:
        return self.mul_extension_with_const(1, a, b)

    def mul_many_extension(self, terms) -> ExtensionTarget:
        acc = self.one_extension()
        for t in terms:
            acc = self.mul_extension(acc, t)
        return acc

    def mul_add_extension(self, a, b, c) -> ExtensionTarget:
        return self.arithmetic_extension(1, 1, a, b, c)

    def mul_sub_extension(self, a, b, c) -> ExtensionTarget:
        return self.arithmetic_extension(1, gl.P - 1, a, b, c)

    def square_extension(self, x) -> ExtensionTarget:
        return self.mul_extension(x, x)

    def add_const_extension(self, x, c: int) -> ExtensionTarget:
        return self.add_extension(x, self.constant_extension((c, 0)))

    def mul_const_extension(self, c: int, x) -> ExtensionTarget:
        return self.mul_extension_with_const(c, x, self.one_extension())

    def mul_const_add_extension(self, c: int, x, y) -> ExtensionTarget:
        return self.arithmetic_extension(c, 1, x, self.one_extension(), y)

    def scalar_mul_ext(self, a: Target, b: ExtensionTarget) -> ExtensionTarget:
        return self.mul_extension(self.convert_to_ext(a), b)

    def scalar_mul_add_extension(self, a: Target, b, c) -> ExtensionTarget:
        return self.arithmetic_extension(1, 1, self.convert_to_ext(a), b, c)

    def exp_power_of_2_extension(self, base,
                                 power_log: int) -> ExtensionTarget:
        for _ in range(power_log):
            base = self.square_extension(base)
        return base

    def exp_u64_extension(self, base, exponent: int) -> ExtensionTarget:
        if exponent == 0:
            return self.one_extension()
        if exponent == 1:
            return base
        current = base
        product = self.one_extension()
        j = 0
        while (exponent >> j) != 0:
            if j != 0:
                current = self.square_extension(current)
            if (exponent >> j) & 1:
                # mul_extension folds product==1 to `current` automatically
                product = self.mul_extension(product, current)
            j += 1
        return product

    # -- division (witness-hinted inverse) --------------------------------

    def div_add_extension(self, x, y, z) -> ExtensionTarget:
        inv = self.add_virtual_extension_target()
        one = self.one_extension()
        self.generators.append(QuotientGeneratorExtension(one, y, inv))
        y_inv = self.mul_extension(y, inv)
        self.connect_extension(y_inv, one)
        return self.mul_add_extension(x, inv, z)

    def div_extension(self, x, y) -> ExtensionTarget:
        return self.div_add_extension(x, y, self.zero_extension())

    def inverse_extension(self, x) -> ExtensionTarget:
        return self.div_extension(self.one_extension(), x)

    def div(self, x: Target, y: Target) -> Target:
        return self.div_extension(self.convert_to_ext(x),
                                  self.convert_to_ext(y))[0]

    def inverse(self, x: Target) -> Target:
        return self.inverse_extension(self.convert_to_ext(x))[0]

    # -- select (reference gadgets/select.rs) -----------------------------

    def select_ext(self, b: Target, x: ExtensionTarget,
                   y: ExtensionTarget) -> ExtensionTarget:
        b_ext = self.convert_to_ext(b)
        return self.select_ext_generalized(b_ext, x, y)

    def select_ext_generalized(self, b, x, y) -> ExtensionTarget:
        tmp = self.mul_sub_extension(b, y, y)
        return self.mul_sub_extension(b, x, tmp)

    def select(self, b: Target, x: Target, y: Target) -> Target:
        tmp = self.arithmetic(1, gl.P - 1, b, y, y)  # b*y - y
        return self.arithmetic(1, gl.P - 1, b, x, tmp)  # b*x - tmp
