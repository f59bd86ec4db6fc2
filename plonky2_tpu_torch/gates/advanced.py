"""The gates of plonky2's recursion gate set beyond the basic ones, each
with its witness generator (the port's copy of
plonky2_tpu/gates/advanced.py; reference gates/base_sum.rs,
exponentiation.rs, random_access.rs, reducing.rs, reducing_extension.rs,
arithmetic_extension.rs, multiplication_extension.rs, poseidon_mds.rs).

BaseSum, Exponentiation, RandomAccess, Reducing, ReducingExtension,
ArithmeticExtension, MulExtension and PoseidonMds.  Each gate's ``id()``
is the reference's, byte for byte: it keys the gate set and orders the
gates (plonk/circuit_builder.py), which sets the selectors and so the
quotient's program.  The generators are scalar (one at a time in the host
engine, iop/generator.py); the device witness plan refuses a circuit that
has them.
"""
from __future__ import annotations

from ..field import extension as ge
from ..field import goldilocks as gl
from ..hash import poseidon as pos
from ..iop.generator import SimpleGenerator
from .ext_algebra import (ea_add, ea_from_base, ea_mul, ea_scalar_mul,
                          ea_scalar_mul_const, ea_sub, get_local_ext)
from .gate import Gate

D = 2
_PHANTOM = "PhantomData<plonky2_field::goldilocks_field::GoldilocksField>"


# -- BaseSumGate ------------------------------------------------------------

class BaseSumGate(Gate):
    """Decomposes wire 0 into `num_limbs` base-B little-endian limbs."""

    WIRE_SUM = 0
    START_LIMBS = 1

    def __init__(self, num_limbs: int, base: int):
        self.num_limbs = num_limbs
        self.base = base

    @staticmethod
    def new_from_config(config, base: int) -> "BaseSumGate":
        log_floor = 0
        acc = 1
        while acc * base <= gl.P - 1:
            acc *= base
            log_floor += 1
        return BaseSumGate(min(log_floor, config.num_routed_wires
                               - BaseSumGate.START_LIMBS), base)

    def id(self):
        return (f"BaseSumGate {{ num_limbs: {self.num_limbs} }} + Base: "
                f"{self.base}")

    def limbs(self) -> range:
        return range(self.START_LIMBS, self.START_LIMBS + self.num_limbs)

    def eval_unfiltered(self, alg, vars):
        s = vars.local_wires[self.WIRE_SUM]
        limbs = [vars.local_wires[i] for i in self.limbs()]
        computed = alg.zero()
        for limb in reversed(limbs):
            computed = alg.add(alg.mul_const(computed, self.base), limb)
        constraints = [alg.sub(computed, s)]
        for limb in limbs:
            prod = limb
            for i in range(1, self.base):
                prod = alg.mul(prod, alg.add_const(limb, gl.P - i))
            constraints.append(prod)
        return constraints

    def generators(self, row, local_constants):
        return [BaseSplitGenerator(row, self.num_limbs, self.base)]

    def num_wires(self):
        return 1 + self.num_limbs

    def num_constants(self):
        return 0

    def degree(self):
        return self.base

    def num_constraints(self):
        return 1 + self.num_limbs


class BaseSplitGenerator(SimpleGenerator):
    def __init__(self, row, num_limbs, base):
        self.row = row
        self.num_limbs = num_limbs
        self.base = base

    def dependencies(self):
        return [("w", self.row, BaseSumGate.WIRE_SUM)]

    def run_once(self, witness, out):
        v = witness.get_target(("w", self.row, BaseSumGate.WIRE_SUM))
        acc = v
        for i in range(self.num_limbs):
            out.append((("w", self.row, BaseSumGate.START_LIMBS + i),
                        acc % self.base))
            acc //= self.base
        if acc:
            raise ValueError("Integer too large to fit in given number of "
                             "limbs")


# -- ExponentiationGate -------------------------------------------------------

class ExponentiationGate(Gate):
    def __init__(self, num_power_bits: int):
        self.num_power_bits = num_power_bits

    @staticmethod
    def new_from_config(config) -> "ExponentiationGate":
        return ExponentiationGate(min(config.num_routed_wires - 2,
                                      (config.num_wires - 2) // 2))

    def id(self):
        return (f"ExponentiationGate {{ num_power_bits: {self.num_power_bits},"
                f" _phantom: {_PHANTOM} }}")

    def wire_base(self):
        return 0

    def wire_power_bit(self, i):
        return 1 + i

    def wire_output(self):
        return 1 + self.num_power_bits

    def wire_intermediate_value(self, i):
        return 2 + self.num_power_bits + i

    def eval_unfiltered(self, alg, vars):
        base = vars.local_wires[self.wire_base()]
        n = self.num_power_bits
        bits = [vars.local_wires[self.wire_power_bit(i)] for i in range(n)]
        inter = [vars.local_wires[self.wire_intermediate_value(i)]
                 for i in range(n)]
        output = vars.local_wires[self.wire_output()]
        one = alg.one()
        constraints = []
        for i in range(n):
            prev = one if i == 0 else alg.mul(inter[i - 1], inter[i - 1])
            cur_bit = bits[n - i - 1]
            not_bit = alg.sub(one, cur_bit)
            computed = alg.mul(prev, alg.add(alg.mul(cur_bit, base), not_bit))
            constraints.append(alg.sub(computed, inter[i]))
        constraints.append(alg.sub(output, inter[n - 1]))
        return constraints

    def generators(self, row, local_constants):
        return [ExponentiationGenerator(row, self)]

    def num_wires(self):
        return self.wire_intermediate_value(self.num_power_bits - 1) + 1

    def num_constants(self):
        return 0

    def degree(self):
        return 4

    def num_constraints(self):
        return self.num_power_bits + 1


class ExponentiationGenerator(SimpleGenerator):
    def __init__(self, row, gate: ExponentiationGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        g = self.gate
        return ([("w", self.row, g.wire_base())]
                + [("w", self.row, g.wire_power_bit(i))
                   for i in range(g.num_power_bits)])

    def run_once(self, witness, out):
        g = self.gate
        n = g.num_power_bits
        base = witness.get_target(("w", self.row, g.wire_base()))
        bits = [witness.get_target(("w", self.row, g.wire_power_bit(i)))
                for i in range(n)]
        cur = 1
        inter = []
        for i in range(n):
            if bits[n - i - 1] == 1:
                cur = cur * base % gl.P
            inter.append(cur)
            cur = cur * cur % gl.P
        for i in range(n):
            out.append((("w", self.row, g.wire_intermediate_value(i)),
                        inter[i]))
        out.append((("w", self.row, g.wire_output()), inter[n - 1]))


# -- RandomAccessGate ---------------------------------------------------------

class RandomAccessGate(Gate):
    def __init__(self, bits: int, num_copies: int, num_extra_constants: int):
        self.bits = bits
        self.num_copies = num_copies
        self.num_extra_constants = num_extra_constants

    @staticmethod
    def new_from_config(config, bits: int) -> "RandomAccessGate":
        vec_size = 1 << bits
        max_copies = min(config.num_routed_wires // (2 + vec_size),
                         config.num_wires // (2 + vec_size + bits))
        max_extra = config.num_routed_wires - (2 + vec_size) * max_copies
        return RandomAccessGate(bits, max_copies,
                                min(max_extra, config.num_constants))

    def id(self):
        return (f"RandomAccessGate {{ bits: {self.bits}, num_copies: "
                f"{self.num_copies}, num_extra_constants: "
                f"{self.num_extra_constants}, _phantom: {_PHANTOM} }}")

    def vec_size(self):
        return 1 << self.bits

    def wire_access_index(self, copy):
        return (2 + self.vec_size()) * copy

    def wire_claimed_element(self, copy):
        return (2 + self.vec_size()) * copy + 1

    def wire_list_item(self, i, copy):
        return (2 + self.vec_size()) * copy + 2 + i

    def num_routed_wires_used(self):
        return ((2 + self.vec_size()) * self.num_copies
                + self.num_extra_constants)

    def wire_extra_constant(self, i):
        return (2 + self.vec_size()) * self.num_copies + i

    def wire_bit(self, i, copy):
        return self.num_routed_wires_used() - self.num_extra_constants \
            + self.num_extra_constants + copy * self.bits + i

    def eval_unfiltered(self, alg, vars):
        constraints = []
        one = alg.one()
        for copy in range(self.num_copies):
            access_index = vars.local_wires[self.wire_access_index(copy)]
            items = [vars.local_wires[self.wire_list_item(i, copy)]
                     for i in range(self.vec_size())]
            claimed = vars.local_wires[self.wire_claimed_element(copy)]
            bits = [vars.local_wires[self.wire_bit(i, copy)]
                    for i in range(self.bits)]
            for b in bits:
                constraints.append(alg.mul(b, alg.sub(b, one)))
            recon = alg.zero()
            for b in reversed(bits):
                recon = alg.add(alg.add(recon, recon), b)
            constraints.append(alg.sub(recon, access_index))
            for b in bits:
                items = [alg.add(items[2 * k],
                                 alg.mul(b, alg.sub(items[2 * k + 1],
                                                    items[2 * k])))
                         for k in range(len(items) // 2)]
            constraints.append(alg.sub(items[0], claimed))
        for i in range(self.num_extra_constants):
            constraints.append(alg.sub(
                vars.local_constants[i],
                vars.local_wires[self.wire_extra_constant(i)]))
        return constraints

    def generators(self, row, local_constants):
        return [RandomAccessGenerator(row, self, c)
                for c in range(self.num_copies)]

    def num_wires(self):
        return self.wire_bit(self.bits - 1, self.num_copies - 1) + 1

    def num_constants(self):
        return self.num_extra_constants

    def degree(self):
        return self.bits + 1

    def num_constraints(self):
        return self.num_copies * (self.bits + 2) + self.num_extra_constants

    def extra_constant_wires(self):
        return [(i, self.wire_extra_constant(i))
                for i in range(self.num_extra_constants)]


class RandomAccessGenerator(SimpleGenerator):
    def __init__(self, row, gate: RandomAccessGate, copy: int):
        self.row = row
        self.gate = gate
        self.copy = copy

    def dependencies(self):
        g = self.gate
        return ([("w", self.row, g.wire_access_index(self.copy))]
                + [("w", self.row, g.wire_list_item(i, self.copy))
                   for i in range(g.vec_size())])

    def run_once(self, witness, out):
        g = self.gate
        copy = self.copy
        idx = witness.get_target(("w", self.row, g.wire_access_index(copy)))
        if idx >= g.vec_size():
            raise ValueError(f"access index {idx} out of range")
        out.append((("w", self.row, g.wire_claimed_element(copy)),
                    witness.get_target(("w", self.row,
                                        g.wire_list_item(idx, copy)))))
        for i in range(g.bits):
            out.append((("w", self.row, g.wire_bit(i, copy)), (idx >> i) & 1))


# -- ReducingGate / ReducingExtensionGate -------------------------------------

class ReducingGate(Gate):
    """acc_i = acc_{i-1} * alpha + coeff_i with base-field coefficients."""

    def __init__(self, num_coeffs: int):
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires):
        return min(num_routed_wires - 3 * D, (num_wires - 2 * D) // (D + 1))

    def id(self):
        return f"ReducingGate {{ num_coeffs: {self.num_coeffs} }}"

    @staticmethod
    def wires_output():
        return range(0, D)

    @staticmethod
    def wires_alpha():
        return range(D, 2 * D)

    @staticmethod
    def wires_old_acc():
        return range(2 * D, 3 * D)

    def wires_coeffs(self):
        return range(3 * D, 3 * D + self.num_coeffs)

    def wires_accs(self, i):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        start = 3 * D + self.num_coeffs
        return range(start + D * i, start + D * (i + 1))

    def eval_unfiltered(self, alg, vars):
        alpha = get_local_ext(vars, self.wires_alpha())
        old_acc = get_local_ext(vars, self.wires_old_acc())
        coeffs = [vars.local_wires[i] for i in self.wires_coeffs()]
        accs = [get_local_ext(vars, self.wires_accs(i))
                for i in range(self.num_coeffs)]
        constraints = []
        acc = old_acc
        for i in range(self.num_coeffs):
            t = ea_sub(alg, ea_add(alg, ea_mul(alg, acc, alpha),
                                   ea_from_base(alg, coeffs[i])), accs[i])
            constraints.extend(t)
            acc = accs[i]
        return constraints

    def generators(self, row, local_constants):
        return [ReducingGenerator(row, self)]

    def num_wires(self):
        return 3 * D + self.num_coeffs + D * (self.num_coeffs - 1)

    def num_constants(self):
        return 0

    def degree(self):
        return 2

    def num_constraints(self):
        return D * self.num_coeffs


class ReducingGenerator(SimpleGenerator):
    def __init__(self, row, gate: ReducingGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        g = self.gate
        cols = (list(g.wires_alpha()) + list(g.wires_old_acc())
                + list(g.wires_coeffs()))
        return [("w", self.row, c) for c in cols]

    def run_once(self, witness, out):
        g = self.gate
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        alpha = tuple(w(c) for c in g.wires_alpha())
        acc = tuple(w(c) for c in g.wires_old_acc())
        coeffs = [w(c) for c in g.wires_coeffs()]
        for i in range(g.num_coeffs):
            acc = ge.s_add(ge.s_mul(acc, alpha), (coeffs[i], 0))
            r = g.wires_accs(i)
            out.append((("w", self.row, r.start), acc[0]))
            out.append((("w", self.row, r.start + 1), acc[1]))


class ReducingExtensionGate(Gate):
    """Like ReducingGate but with extension-field coefficients."""

    def __init__(self, num_coeffs: int):
        self.num_coeffs = num_coeffs

    @staticmethod
    def max_coeffs_len(num_wires, num_routed_wires):
        return min((num_routed_wires - 3 * D) // D,
                   (num_wires - 2 * D) // (2 * D))

    def id(self):
        return f"ReducingExtensionGate {{ num_coeffs: {self.num_coeffs} }}"

    wires_output = staticmethod(ReducingGate.wires_output)
    wires_alpha = staticmethod(ReducingGate.wires_alpha)
    wires_old_acc = staticmethod(ReducingGate.wires_old_acc)

    @staticmethod
    def wires_coeff(i):
        return range(3 * D + i * D, 3 * D + (i + 1) * D)

    def wires_accs(self, i):
        if i == self.num_coeffs - 1:
            return self.wires_output()
        start = 3 * D + self.num_coeffs * D
        return range(start + D * i, start + D * (i + 1))

    def eval_unfiltered(self, alg, vars):
        alpha = get_local_ext(vars, self.wires_alpha())
        old_acc = get_local_ext(vars, self.wires_old_acc())
        coeffs = [get_local_ext(vars, self.wires_coeff(i))
                  for i in range(self.num_coeffs)]
        accs = [get_local_ext(vars, self.wires_accs(i))
                for i in range(self.num_coeffs)]
        constraints = []
        acc = old_acc
        for i in range(self.num_coeffs):
            t = ea_sub(alg, ea_add(alg, ea_mul(alg, acc, alpha), coeffs[i]),
                       accs[i])
            constraints.extend(t)
            acc = accs[i]
        return constraints

    def generators(self, row, local_constants):
        return [ReducingExtensionGenerator(row, self)]

    def num_wires(self):
        return 3 * D + self.num_coeffs * D + D * (self.num_coeffs - 1)

    def num_constants(self):
        return 0

    def degree(self):
        return 2

    def num_constraints(self):
        return D * self.num_coeffs


class ReducingExtensionGenerator(SimpleGenerator):
    def __init__(self, row, gate: ReducingExtensionGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        g = self.gate
        cols = list(g.wires_alpha()) + list(g.wires_old_acc())
        for i in range(g.num_coeffs):
            cols += list(g.wires_coeff(i))
        return [("w", self.row, c) for c in cols]

    def run_once(self, witness, out):
        g = self.gate
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        alpha = tuple(w(c) for c in g.wires_alpha())
        acc = tuple(w(c) for c in g.wires_old_acc())
        for i in range(g.num_coeffs):
            coeff = tuple(w(c) for c in g.wires_coeff(i))
            acc = ge.s_add(ge.s_mul(acc, alpha), coeff)
            r = g.wires_accs(i)
            out.append((("w", self.row, r.start), acc[0]))
            out.append((("w", self.row, r.start + 1), acc[1]))


# -- ArithmeticExtensionGate / MulExtensionGate -------------------------------

class ArithmeticExtensionGate(Gate):
    def __init__(self, num_ops: int):
        self.n_ops = num_ops

    @staticmethod
    def new_from_config(config) -> "ArithmeticExtensionGate":
        return ArithmeticExtensionGate(config.num_routed_wires // (4 * D))

    def id(self):
        return f"ArithmeticExtensionGate {{ num_ops: {self.n_ops} }}"

    @staticmethod
    def wires_ith_multiplicand_0(i):
        return range(4 * D * i, 4 * D * i + D)

    @staticmethod
    def wires_ith_multiplicand_1(i):
        return range(4 * D * i + D, 4 * D * i + 2 * D)

    @staticmethod
    def wires_ith_addend(i):
        return range(4 * D * i + 2 * D, 4 * D * i + 3 * D)

    @staticmethod
    def wires_ith_output(i):
        return range(4 * D * i + 3 * D, 4 * D * i + 4 * D)

    def eval_unfiltered(self, alg, vars):
        c0 = vars.local_constants[0]
        c1 = vars.local_constants[1]
        constraints = []
        for i in range(self.n_ops):
            m0 = get_local_ext(vars, self.wires_ith_multiplicand_0(i))
            m1 = get_local_ext(vars, self.wires_ith_multiplicand_1(i))
            addend = get_local_ext(vars, self.wires_ith_addend(i))
            output = get_local_ext(vars, self.wires_ith_output(i))
            computed = ea_add(alg, ea_scalar_mul(alg, ea_mul(alg, m0, m1), c0),
                              ea_scalar_mul(alg, addend, c1))
            constraints.extend(ea_sub(alg, output, computed))
        return constraints

    def generators(self, row, local_constants):
        return [ArithmeticExtensionGenerator(row, int(local_constants[0]),
                                             int(local_constants[1]), i)
                for i in range(self.n_ops)]

    def num_wires(self):
        return self.n_ops * 4 * D

    def num_constants(self):
        return 2

    def degree(self):
        return 3

    def num_constraints(self):
        return self.n_ops * D

    def num_ops(self):
        return self.n_ops


class ArithmeticExtensionGenerator(SimpleGenerator):
    def __init__(self, row, const_0, const_1, i):
        self.row = row
        self.const_0 = const_0
        self.const_1 = const_1
        self.i = i

    def dependencies(self):
        g = ArithmeticExtensionGate
        cols = (list(g.wires_ith_multiplicand_0(self.i))
                + list(g.wires_ith_multiplicand_1(self.i))
                + list(g.wires_ith_addend(self.i)))
        return [("w", self.row, c) for c in cols]

    def run_once(self, witness, out):
        g = ArithmeticExtensionGate
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        m0 = tuple(w(c) for c in g.wires_ith_multiplicand_0(self.i))
        m1 = tuple(w(c) for c in g.wires_ith_multiplicand_1(self.i))
        addend = tuple(w(c) for c in g.wires_ith_addend(self.i))
        v = ge.s_add(ge.s_mul(ge.s_mul(m0, m1), (self.const_0, 0)),
                     ge.s_mul(addend, (self.const_1, 0)))
        r = g.wires_ith_output(self.i)
        out.append((("w", self.row, r.start), v[0]))
        out.append((("w", self.row, r.start + 1), v[1]))


class MulExtensionGate(Gate):
    def __init__(self, num_ops: int):
        self.n_ops = num_ops

    @staticmethod
    def new_from_config(config) -> "MulExtensionGate":
        return MulExtensionGate(config.num_routed_wires // (3 * D))

    def id(self):
        return f"MulExtensionGate {{ num_ops: {self.n_ops} }}"

    @staticmethod
    def wires_ith_multiplicand_0(i):
        return range(3 * D * i, 3 * D * i + D)

    @staticmethod
    def wires_ith_multiplicand_1(i):
        return range(3 * D * i + D, 3 * D * i + 2 * D)

    @staticmethod
    def wires_ith_output(i):
        return range(3 * D * i + 2 * D, 3 * D * i + 3 * D)

    def eval_unfiltered(self, alg, vars):
        c0 = vars.local_constants[0]
        constraints = []
        for i in range(self.n_ops):
            m0 = get_local_ext(vars, self.wires_ith_multiplicand_0(i))
            m1 = get_local_ext(vars, self.wires_ith_multiplicand_1(i))
            output = get_local_ext(vars, self.wires_ith_output(i))
            computed = ea_scalar_mul(alg, ea_mul(alg, m0, m1), c0)
            constraints.extend(ea_sub(alg, output, computed))
        return constraints

    def generators(self, row, local_constants):
        return [MulExtensionGenerator(row, int(local_constants[0]), i)
                for i in range(self.n_ops)]

    def num_wires(self):
        return self.n_ops * 3 * D

    def num_constants(self):
        return 1

    def degree(self):
        return 3

    def num_constraints(self):
        return self.n_ops * D

    def num_ops(self):
        return self.n_ops


class MulExtensionGenerator(SimpleGenerator):
    def __init__(self, row, const_0, i):
        self.row = row
        self.const_0 = const_0
        self.i = i

    def dependencies(self):
        g = MulExtensionGate
        cols = (list(g.wires_ith_multiplicand_0(self.i))
                + list(g.wires_ith_multiplicand_1(self.i)))
        return [("w", self.row, c) for c in cols]

    def run_once(self, witness, out):
        g = MulExtensionGate
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        m0 = tuple(w(c) for c in g.wires_ith_multiplicand_0(self.i))
        m1 = tuple(w(c) for c in g.wires_ith_multiplicand_1(self.i))
        v = ge.s_mul(ge.s_mul(m0, m1), (self.const_0, 0))
        r = g.wires_ith_output(self.i)
        out.append((("w", self.row, r.start), v[0]))
        out.append((("w", self.row, r.start + 1), v[1]))


# -- PoseidonMdsGate ----------------------------------------------------------

class PoseidonMdsGate(Gate):
    WIDTH = 12

    def id(self):
        return ("PoseidonMdsGate(PhantomData<plonky2_field::goldilocks_field::"
                "GoldilocksField>)<WIDTH=12>")

    @staticmethod
    def wires_input(i):
        return range(i * D, (i + 1) * D)

    @staticmethod
    def wires_output(i):
        return range((12 + i) * D, (12 + i + 1) * D)

    def eval_unfiltered(self, alg, vars):
        inputs = [get_local_ext(vars, self.wires_input(i)) for i in range(12)]
        circ = [int(x) for x in pos.MDS_CIRC]
        diag = [int(x) for x in pos.MDS_DIAG]
        constraints = []
        for r in range(12):
            acc = (alg.zero(), alg.zero())
            for i in range(12):
                acc = ea_add(alg, acc, ea_scalar_mul_const(
                    alg, inputs[(i + r) % 12], circ[i]))
            if diag[r]:
                acc = ea_add(alg, acc,
                             ea_scalar_mul_const(alg, inputs[r], diag[r]))
            output = get_local_ext(vars, self.wires_output(r))
            constraints.extend(ea_sub(alg, output, acc))
        return constraints

    def generators(self, row, local_constants):
        return [PoseidonMdsGenerator(row)]

    def num_wires(self):
        return 2 * D * 12

    def num_constants(self):
        return 0

    def degree(self):
        return 1

    def num_constraints(self):
        return 12 * D


class PoseidonMdsGenerator(SimpleGenerator):
    def __init__(self, row):
        self.row = row

    def dependencies(self):
        cols = []
        for i in range(12):
            cols += list(PoseidonMdsGate.wires_input(i))
        return [("w", self.row, c) for c in cols]

    def run_once(self, witness, out):
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        inputs = [tuple(w(c) for c in PoseidonMdsGate.wires_input(i))
                  for i in range(12)]
        circ = [int(x) for x in pos.MDS_CIRC]
        diag = [int(x) for x in pos.MDS_DIAG]
        for r in range(12):
            acc = (0, 0)
            for i in range(12):
                acc = ge.s_add(acc, ge.s_mul(inputs[(i + r) % 12],
                                             (circ[i], 0)))
            if diag[r]:
                acc = ge.s_add(acc, ge.s_mul(inputs[r], (diag[r], 0)))
            rr = PoseidonMdsGate.wires_output(r)
            out.append((("w", self.row, rr.start), acc[0]))
            out.append((("w", self.row, rr.start + 1), acc[1]))
