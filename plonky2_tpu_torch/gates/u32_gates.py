"""The u32 arithmetic and comparison gates, each with its witness
generator (the port's copy of plonky2_tpu/gates/u32_gates.py; reference
u32/src/gates/: arithmetic_u32.rs, add_many_u32.rs, subtraction_u32.rs,
range_check_u32.rs, comparison.rs).

Each gate's ``id()`` is the reference's, byte for byte: it keys the gate
set and orders the gates, so the selectors and the quotient's program
follow it.  The generators are scalar (the host engine runs them one at a
time; the device witness plan refuses a circuit that has them).
"""
from __future__ import annotations

from ..field import goldilocks as gl
from ..iop.generator import SimpleGenerator
from .gate import Gate

U32_MAX = 0xFFFFFFFF
_PHANTOM = "PhantomData<plonky2_field::goldilocks_field::GoldilocksField>"


def _range_product(alg, limb, max_limb: int):
    prod = limb
    for x in range(1, max_limb):
        prod = alg.mul(prod, alg.add_const(limb, gl.P - x))
    return prod


def _reduce_pow(alg, terms, base: int):
    acc = alg.zero()
    for t in reversed(terms):
        acc = alg.add(alg.mul_const(acc, base), t)
    return acc


# ---------------------------------------------------------------------------
# U32ArithmeticGate: (x*y + z) -> (low32, high32) with base-4 limb range check
# ---------------------------------------------------------------------------

class U32ArithmeticGate(Gate):
    LIMB_BITS = 2
    NUM_LIMBS = 32
    ROUTED_PER_OP = 6

    def __init__(self, num_ops: int):
        self.n_ops = num_ops

    @staticmethod
    def new_from_config(config) -> "U32ArithmeticGate":
        wires_per_op = (U32ArithmeticGate.ROUTED_PER_OP
                        + U32ArithmeticGate.NUM_LIMBS)
        return U32ArithmeticGate(min(config.num_wires // wires_per_op,
                                     config.num_routed_wires
                                     // U32ArithmeticGate.ROUTED_PER_OP))

    def id(self):
        return (f"U32ArithmeticGate {{ num_ops: {self.n_ops}, _phantom: "
                f"{_PHANTOM} }}")

    def wire_ith_multiplicand_0(self, i):
        return self.ROUTED_PER_OP * i

    def wire_ith_multiplicand_1(self, i):
        return self.ROUTED_PER_OP * i + 1

    def wire_ith_addend(self, i):
        return self.ROUTED_PER_OP * i + 2

    def wire_ith_output_low_half(self, i):
        return self.ROUTED_PER_OP * i + 3

    def wire_ith_output_high_half(self, i):
        return self.ROUTED_PER_OP * i + 4

    def wire_ith_inverse(self, i):
        return self.ROUTED_PER_OP * i + 5

    def wire_ith_output_jth_limb(self, i, j):
        return self.ROUTED_PER_OP * self.n_ops + self.NUM_LIMBS * i + j

    def eval_unfiltered(self, alg, vars):
        constraints = []
        one = alg.one()
        for i in range(self.n_ops):
            m0 = vars.local_wires[self.wire_ith_multiplicand_0(i)]
            m1 = vars.local_wires[self.wire_ith_multiplicand_1(i)]
            addend = vars.local_wires[self.wire_ith_addend(i)]
            computed = alg.add(alg.mul(m0, m1), addend)

            out_lo = vars.local_wires[self.wire_ith_output_low_half(i)]
            out_hi = vars.local_wires[self.wire_ith_output_high_half(i)]
            inverse = vars.local_wires[self.wire_ith_inverse(i)]

            # canonicity: not (high == u32::MAX and low != 0)
            diff = alg.sub(alg.const(U32_MAX), out_hi)
            hi_not_max = alg.sub(alg.mul(inverse, diff), one)
            constraints.append(alg.mul(hi_not_max, out_lo))

            combined = alg.add(alg.mul_const(out_hi, 1 << 32), out_lo)
            constraints.append(alg.sub(combined, computed))

            lo_limbs = alg.zero()
            hi_limbs = alg.zero()
            limb_constraints = []
            mid = self.NUM_LIMBS // 2
            for j in range(self.NUM_LIMBS - 1, -1, -1):
                limb = vars.local_wires[self.wire_ith_output_jth_limb(i, j)]
                limb_constraints.append(
                    _range_product(alg, limb, 1 << self.LIMB_BITS))
                if j < mid:
                    lo_limbs = alg.add(
                        alg.mul_const(lo_limbs, 1 << self.LIMB_BITS), limb)
                else:
                    hi_limbs = alg.add(
                        alg.mul_const(hi_limbs, 1 << self.LIMB_BITS), limb)
            constraints.extend(limb_constraints)
            constraints.append(alg.sub(lo_limbs, out_lo))
            constraints.append(alg.sub(hi_limbs, out_hi))
        return constraints

    def generators(self, row, local_constants):
        return [U32ArithmeticGenerator(row, self, i)
                for i in range(self.n_ops)]

    def num_wires(self):
        return self.n_ops * (self.ROUTED_PER_OP + self.NUM_LIMBS)

    def num_constants(self):
        return 0

    def degree(self):
        return 1 << self.LIMB_BITS

    def num_constraints(self):
        return self.n_ops * (4 + self.NUM_LIMBS)

    def num_ops(self):
        return self.n_ops


class U32ArithmeticGenerator(SimpleGenerator):
    def __init__(self, row, gate: U32ArithmeticGate, i: int):
        self.row = row
        self.gate = gate
        self.i = i

    def dependencies(self):
        g, i = self.gate, self.i
        return [("w", self.row, g.wire_ith_multiplicand_0(i)),
                ("w", self.row, g.wire_ith_multiplicand_1(i)),
                ("w", self.row, g.wire_ith_addend(i))]

    def run_once(self, witness, out):
        g, i = self.gate, self.i
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        m0 = w(g.wire_ith_multiplicand_0(i))
        m1 = w(g.wire_ith_multiplicand_1(i))
        addend = w(g.wire_ith_addend(i))
        output = (m0 * m1 + addend) % gl.P
        out_hi, out_lo = output >> 32, output & U32_MAX
        out.append((("w", self.row, g.wire_ith_output_low_half(i)), out_lo))
        out.append((("w", self.row, g.wire_ith_output_high_half(i)), out_hi))
        diff = U32_MAX - out_hi
        inv = 0 if diff == 0 else pow(diff, gl.P - 2, gl.P)
        out.append((("w", self.row, g.wire_ith_inverse(i)), inv))
        acc = output
        for j in range(g.NUM_LIMBS):
            out.append((("w", self.row, g.wire_ith_output_jth_limb(i, j)),
                        acc & ((1 << g.LIMB_BITS) - 1)))
            acc >>= g.LIMB_BITS


# ---------------------------------------------------------------------------
# U32AddManyGate
# ---------------------------------------------------------------------------

class U32AddManyGate(Gate):
    LIMB_BITS = 2
    LOG2_MAX_NUM_ADDENDS = 4
    MAX_NUM_ADDENDS = 16
    NUM_RESULT_LIMBS = 16   # ceil(32 / 2)
    NUM_CARRY_LIMBS = 2     # ceil(4 / 2)
    NUM_LIMBS = 18

    def __init__(self, num_addends: int, num_ops: int):
        if num_addends > self.MAX_NUM_ADDENDS:
            raise ValueError(f"at most {self.MAX_NUM_ADDENDS} addends, got "
                             f"{num_addends}")
        self.num_addends = num_addends
        self.n_ops = num_ops

    @staticmethod
    def new_from_config(config, num_addends: int) -> "U32AddManyGate":
        wires_per_op = (num_addends + 3) + U32AddManyGate.NUM_LIMBS
        routed_per_op = num_addends + 3
        return U32AddManyGate(num_addends,
                              min(config.num_wires // wires_per_op,
                                  config.num_routed_wires // routed_per_op))

    def id(self):
        return (f"U32AddManyGate {{ num_addends: {self.num_addends}, num_ops: "
                f"{self.n_ops}, _phantom: {_PHANTOM} }}")

    def wire_ith_op_jth_addend(self, i, j):
        return (self.num_addends + 3) * i + j

    def wire_ith_carry(self, i):
        return (self.num_addends + 3) * i + self.num_addends

    def wire_ith_output_result(self, i):
        return (self.num_addends + 3) * i + self.num_addends + 1

    def wire_ith_output_carry(self, i):
        return (self.num_addends + 3) * i + self.num_addends + 2

    def wire_ith_output_jth_limb(self, i, j):
        return (self.num_addends + 3) * self.n_ops + self.NUM_LIMBS * i + j

    def eval_unfiltered(self, alg, vars):
        constraints = []
        for i in range(self.n_ops):
            addends = [vars.local_wires[self.wire_ith_op_jth_addend(i, j)]
                       for j in range(self.num_addends)]
            carry = vars.local_wires[self.wire_ith_carry(i)]
            computed = carry
            for a in addends:
                computed = alg.add(computed, a)
            out_result = vars.local_wires[self.wire_ith_output_result(i)]
            out_carry = vars.local_wires[self.wire_ith_output_carry(i)]
            combined = alg.add(alg.mul_const(out_carry, 1 << 32), out_result)
            constraints.append(alg.sub(combined, computed))

            result_limbs = alg.zero()
            carry_limbs = alg.zero()
            limb_constraints = []
            for j in range(self.NUM_LIMBS - 1, -1, -1):
                limb = vars.local_wires[self.wire_ith_output_jth_limb(i, j)]
                limb_constraints.append(
                    _range_product(alg, limb, 1 << self.LIMB_BITS))
                if j < self.NUM_RESULT_LIMBS:
                    result_limbs = alg.add(
                        alg.mul_const(result_limbs, 1 << self.LIMB_BITS), limb)
                else:
                    carry_limbs = alg.add(
                        alg.mul_const(carry_limbs, 1 << self.LIMB_BITS), limb)
            constraints.extend(limb_constraints)
            constraints.append(alg.sub(result_limbs, out_result))
            constraints.append(alg.sub(carry_limbs, out_carry))
        return constraints

    def generators(self, row, local_constants):
        return [U32AddManyGenerator(row, self, i) for i in range(self.n_ops)]

    def num_wires(self):
        return (self.num_addends + 3 + self.NUM_LIMBS) * self.n_ops

    def num_constants(self):
        return 0

    def degree(self):
        return 1 << self.LIMB_BITS

    def num_constraints(self):
        return self.n_ops * (3 + self.NUM_LIMBS)

    def num_ops(self):
        return self.n_ops


class U32AddManyGenerator(SimpleGenerator):
    def __init__(self, row, gate: U32AddManyGate, i: int):
        self.row = row
        self.gate = gate
        self.i = i

    def dependencies(self):
        g, i = self.gate, self.i
        return ([("w", self.row, g.wire_ith_op_jth_addend(i, j))
                 for j in range(g.num_addends)]
                + [("w", self.row, g.wire_ith_carry(i))])

    def run_once(self, witness, out):
        g, i = self.gate, self.i
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        total = sum(w(g.wire_ith_op_jth_addend(i, j))
                    for j in range(g.num_addends)) + w(g.wire_ith_carry(i))
        total %= gl.P
        out_carry, out_result = total >> 32, total & U32_MAX
        out.append((("w", self.row, g.wire_ith_output_result(i)), out_result))
        out.append((("w", self.row, g.wire_ith_output_carry(i)), out_carry))
        acc = out_result
        for j in range(g.NUM_RESULT_LIMBS):
            out.append((("w", self.row, g.wire_ith_output_jth_limb(i, j)),
                        acc & 3))
            acc >>= 2
        acc = out_carry
        for j in range(g.NUM_RESULT_LIMBS, g.NUM_LIMBS):
            out.append((("w", self.row, g.wire_ith_output_jth_limb(i, j)),
                        acc & 3))
            acc >>= 2


# ---------------------------------------------------------------------------
# U32SubtractionGate
# ---------------------------------------------------------------------------

class U32SubtractionGate(Gate):
    LIMB_BITS = 2
    NUM_LIMBS = 16

    def __init__(self, num_ops: int):
        self.n_ops = num_ops

    @staticmethod
    def new_from_config(config) -> "U32SubtractionGate":
        wires_per_op = 5 + U32SubtractionGate.NUM_LIMBS
        return U32SubtractionGate(min(config.num_wires // wires_per_op,
                                      config.num_routed_wires // 5))

    def id(self):
        return (f"U32SubtractionGate {{ num_ops: {self.n_ops}, _phantom: "
                f"{_PHANTOM} }}")

    def wire_ith_input_x(self, i):
        return 5 * i

    def wire_ith_input_y(self, i):
        return 5 * i + 1

    def wire_ith_input_borrow(self, i):
        return 5 * i + 2

    def wire_ith_output_result(self, i):
        return 5 * i + 3

    def wire_ith_output_borrow(self, i):
        return 5 * i + 4

    def wire_ith_output_jth_limb(self, i, j):
        return 5 * self.n_ops + self.NUM_LIMBS * i + j

    def eval_unfiltered(self, alg, vars):
        constraints = []
        one = alg.one()
        for i in range(self.n_ops):
            x = vars.local_wires[self.wire_ith_input_x(i)]
            y = vars.local_wires[self.wire_ith_input_y(i)]
            borrow = vars.local_wires[self.wire_ith_input_borrow(i)]
            result_initial = alg.sub(alg.sub(x, y), borrow)
            out_result = vars.local_wires[self.wire_ith_output_result(i)]
            out_borrow = vars.local_wires[self.wire_ith_output_borrow(i)]
            constraints.append(alg.sub(
                out_result,
                alg.add(result_initial, alg.mul_const(out_borrow, 1 << 32))))

            combined = alg.zero()
            limb_constraints = []
            for j in range(self.NUM_LIMBS - 1, -1, -1):
                limb = vars.local_wires[self.wire_ith_output_jth_limb(i, j)]
                limb_constraints.append(
                    _range_product(alg, limb, 1 << self.LIMB_BITS))
                combined = alg.add(
                    alg.mul_const(combined, 1 << self.LIMB_BITS), limb)
            constraints.extend(limb_constraints)
            constraints.append(alg.sub(combined, out_result))
            constraints.append(alg.mul(out_borrow, alg.sub(one, out_borrow)))
        return constraints

    def generators(self, row, local_constants):
        return [U32SubtractionGenerator(row, self, i)
                for i in range(self.n_ops)]

    def num_wires(self):
        return 5 * self.n_ops + self.NUM_LIMBS * self.n_ops

    def num_constants(self):
        return 0

    def degree(self):
        return 1 << self.LIMB_BITS

    def num_constraints(self):
        return self.n_ops * (3 + self.NUM_LIMBS)

    def num_ops(self):
        return self.n_ops


class U32SubtractionGenerator(SimpleGenerator):
    def __init__(self, row, gate: U32SubtractionGate, i: int):
        self.row = row
        self.gate = gate
        self.i = i

    def dependencies(self):
        g, i = self.gate, self.i
        return [("w", self.row, g.wire_ith_input_x(i)),
                ("w", self.row, g.wire_ith_input_y(i)),
                ("w", self.row, g.wire_ith_input_borrow(i))]

    def run_once(self, witness, out):
        g, i = self.gate, self.i
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        x = w(g.wire_ith_input_x(i))
        y = w(g.wire_ith_input_y(i))
        borrow = w(g.wire_ith_input_borrow(i))
        diff = x - y - borrow
        out_borrow = 1 if diff < 0 else 0
        result = diff + (out_borrow << 32)
        out.append((("w", self.row, g.wire_ith_output_result(i)), result))
        out.append((("w", self.row, g.wire_ith_output_borrow(i)), out_borrow))
        acc = result
        for j in range(g.NUM_LIMBS):
            out.append((("w", self.row, g.wire_ith_output_jth_limb(i, j)),
                        acc & 3))
            acc >>= 2


# ---------------------------------------------------------------------------
# U32RangeCheckGate
# ---------------------------------------------------------------------------

class U32RangeCheckGate(Gate):
    AUX_LIMB_BITS = 2
    BASE = 4
    AUX_PER_INPUT = 16  # ceil(32 / 2)

    def __init__(self, num_input_limbs: int):
        self.num_input_limbs = num_input_limbs

    def id(self):
        return (f"U32RangeCheckGate {{ num_input_limbs: "
                f"{self.num_input_limbs}, _phantom: {_PHANTOM} }}")

    def wire_ith_input_limb(self, i):
        return i

    def wire_ith_input_limb_jth_aux_limb(self, i, j):
        return self.num_input_limbs + self.AUX_PER_INPUT * i + j

    def eval_unfiltered(self, alg, vars):
        constraints = []
        for i in range(self.num_input_limbs):
            input_limb = vars.local_wires[self.wire_ith_input_limb(i)]
            aux = [vars.local_wires[
                self.wire_ith_input_limb_jth_aux_limb(i, j)]
                for j in range(self.AUX_PER_INPUT)]
            computed = _reduce_pow(alg, aux, self.BASE)
            constraints.append(alg.sub(computed, input_limb))
            for a in aux:
                constraints.append(_range_product(alg, a, self.BASE))
        return constraints

    def generators(self, row, local_constants):
        return [U32RangeCheckGenerator(row, self)]

    def num_wires(self):
        return self.num_input_limbs * (1 + self.AUX_PER_INPUT)

    def num_constants(self):
        return 0

    def degree(self):
        return self.BASE

    def num_constraints(self):
        return self.num_input_limbs * (1 + self.AUX_PER_INPUT)


class U32RangeCheckGenerator(SimpleGenerator):
    def __init__(self, row, gate: U32RangeCheckGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        g = self.gate
        return [("w", self.row, g.wire_ith_input_limb(i))
                for i in range(g.num_input_limbs)]

    def run_once(self, witness, out):
        g = self.gate
        for i in range(g.num_input_limbs):
            v = witness.get_target(("w", self.row, g.wire_ith_input_limb(i)))
            if v >= 1 << 32:
                raise ValueError(f"{v} does not fit in 32 bits")
            acc = v
            for j in range(g.AUX_PER_INPUT):
                out.append((("w", self.row,
                             g.wire_ith_input_limb_jth_aux_limb(i, j)),
                            acc & 3))
                acc >>= 2


# ---------------------------------------------------------------------------
# ComparisonGate: result = (first <= second)
# ---------------------------------------------------------------------------

class ComparisonGate(Gate):
    def __init__(self, num_bits: int, num_chunks: int):
        self.num_bits = num_bits
        self.num_chunks = num_chunks

    def id(self):
        return (f"ComparisonGate {{ num_bits: {self.num_bits}, num_chunks: "
                f"{self.num_chunks}, _phantom: {_PHANTOM} }}<D=2>")

    def chunk_bits(self):
        return -(-self.num_bits // self.num_chunks)

    def wire_first_input(self):
        return 0

    def wire_second_input(self):
        return 1

    def wire_result_bool(self):
        return 2

    def wire_most_significant_diff(self):
        return 3

    def wire_first_chunk_val(self, chunk):
        return 4 + chunk

    def wire_second_chunk_val(self, chunk):
        return 4 + self.num_chunks + chunk

    def wire_equality_dummy(self, chunk):
        return 4 + 2 * self.num_chunks + chunk

    def wire_chunks_equal(self, chunk):
        return 4 + 3 * self.num_chunks + chunk

    def wire_intermediate_value(self, chunk):
        return 4 + 4 * self.num_chunks + chunk

    def wire_most_significant_diff_bit(self, bit_index):
        return 4 + 5 * self.num_chunks + bit_index

    def eval_unfiltered(self, alg, vars):
        constraints = []
        one = alg.one()
        cb = self.chunk_bits()
        chunk_size = 1 << cb
        first = vars.local_wires[self.wire_first_input()]
        second = vars.local_wires[self.wire_second_input()]
        fc = [vars.local_wires[self.wire_first_chunk_val(c)]
              for c in range(self.num_chunks)]
        sc = [vars.local_wires[self.wire_second_chunk_val(c)]
              for c in range(self.num_chunks)]
        constraints.append(alg.sub(_reduce_pow(alg, fc, chunk_size), first))
        constraints.append(alg.sub(_reduce_pow(alg, sc, chunk_size), second))

        msd_so_far = alg.zero()
        for i in range(self.num_chunks):
            constraints.append(_range_product(alg, fc[i], chunk_size))
            constraints.append(_range_product(alg, sc[i], chunk_size))
            difference = alg.sub(sc[i], fc[i])
            eq_dummy = vars.local_wires[self.wire_equality_dummy(i)]
            chunks_equal = vars.local_wires[self.wire_chunks_equal(i)]
            constraints.append(alg.sub(alg.mul(difference, eq_dummy),
                                       alg.sub(one, chunks_equal)))
            constraints.append(alg.mul(chunks_equal, difference))
            inter = vars.local_wires[self.wire_intermediate_value(i)]
            constraints.append(alg.sub(inter,
                                       alg.mul(chunks_equal, msd_so_far)))
            msd_so_far = alg.add(inter, alg.mul(alg.sub(one, chunks_equal),
                                                difference))

        msd = vars.local_wires[self.wire_most_significant_diff()]
        constraints.append(alg.sub(msd, msd_so_far))

        bits = [vars.local_wires[self.wire_most_significant_diff_bit(i)]
                for i in range(cb + 1)]
        for b in bits:
            constraints.append(alg.mul(b, alg.sub(one, b)))
        bits_combined = _reduce_pow(alg, bits, 2)
        constraints.append(alg.sub(alg.add_const(msd, 1 << cb), bits_combined))
        result = vars.local_wires[self.wire_result_bool()]
        constraints.append(alg.sub(result, bits[cb]))
        return constraints

    def generators(self, row, local_constants):
        return [ComparisonGenerator(row, self)]

    def num_wires(self):
        return 4 + 5 * self.num_chunks + self.chunk_bits() + 1

    def num_constants(self):
        return 0

    def degree(self):
        return 1 << self.chunk_bits()

    def num_constraints(self):
        return 6 + 5 * self.num_chunks + self.chunk_bits()


class ComparisonGenerator(SimpleGenerator):
    def __init__(self, row, gate: ComparisonGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        g = self.gate
        return [("w", self.row, g.wire_first_input()),
                ("w", self.row, g.wire_second_input())]

    def run_once(self, witness, out):
        g = self.gate
        row = self.row
        first = witness.get_target(("w", row, g.wire_first_input()))
        second = witness.get_target(("w", row, g.wire_second_input()))
        cb = g.chunk_bits()
        chunk_size = 1 << cb

        out.append((("w", row, g.wire_result_bool()), int(first <= second)))

        fchunks, schunks = [], []
        af, asnd = first, second
        for _ in range(g.num_chunks):
            fchunks.append(af % chunk_size)
            schunks.append(asnd % chunk_size)
            af //= chunk_size
            asnd //= chunk_size
        for i in range(g.num_chunks):
            out.append((("w", row, g.wire_first_chunk_val(i)), fchunks[i]))
            out.append((("w", row, g.wire_second_chunk_val(i)), schunks[i]))
            eq = int(fchunks[i] == schunks[i])
            out.append((("w", row, g.wire_chunks_equal(i)), eq))
            dummy = 1 if eq else pow((schunks[i] - fchunks[i]) % gl.P,
                                     gl.P - 2, gl.P)
            out.append((("w", row, g.wire_equality_dummy(i)), dummy))

        msd = 0
        for i in range(g.num_chunks):
            if fchunks[i] != schunks[i]:
                out.append((("w", row, g.wire_intermediate_value(i)), 0))
                msd = (schunks[i] - fchunks[i]) % gl.P
            else:
                out.append((("w", row, g.wire_intermediate_value(i)), msd))
        out.append((("w", row, g.wire_most_significant_diff()), msd))

        two_n_plus = ((1 << cb) + msd) % gl.P
        for i in range(cb + 1):
            out.append((("w", row, g.wire_most_significant_diff_bit(i)),
                        (two_n_plus >> i) & 1))
