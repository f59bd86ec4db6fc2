"""The chunked less-than-or-equal assertion gate (the port's copy of
plonky2_tpu/gates/assert_le.py; reference waksman/src/gates/assert_le.rs).

It splits both inputs into chunks of base 2^chunk_bits and checks that the
most significant chunk where they differ is larger in the second input.
"""
from __future__ import annotations

from ..field import goldilocks as gl
from ..iop.generator import SimpleGenerator
from .gate import Gate


class AssertLessThanGate(Gate):
    def __init__(self, num_bits: int, num_chunks: int):
        if num_bits >= 64:
            raise ValueError(f"num_bits {num_bits} must be below 64")
        self.num_bits = num_bits
        self.num_chunks = num_chunks

    def chunk_bits(self) -> int:
        return -(-self.num_bits // self.num_chunks)

    def id(self):
        return (f"AssertLessThanGate {{ num_bits: {self.num_bits}, num_chunks:"
                f" {self.num_chunks}, _phantom: PhantomData"
                f"<plonky2_field::goldilocks_field::GoldilocksField> }}<D=2>")

    def wire_first_input(self):
        return 0

    def wire_second_input(self):
        return 1

    def wire_most_significant_diff(self):
        return 2

    def wire_first_chunk_val(self, chunk):
        return 3 + chunk

    def wire_second_chunk_val(self, chunk):
        return 3 + self.num_chunks + chunk

    def wire_equality_dummy(self, chunk):
        return 3 + 2 * self.num_chunks + chunk

    def wire_chunks_equal(self, chunk):
        return 3 + 3 * self.num_chunks + chunk

    def wire_intermediate_value(self, chunk):
        return 3 + 4 * self.num_chunks + chunk

    def eval_unfiltered(self, alg, vars):
        constraints = []
        one = alg.one()
        first_input = vars.local_wires[self.wire_first_input()]
        second_input = vars.local_wires[self.wire_second_input()]
        first_chunks = [vars.local_wires[self.wire_first_chunk_val(i)]
                        for i in range(self.num_chunks)]
        second_chunks = [vars.local_wires[self.wire_second_chunk_val(i)]
                         for i in range(self.num_chunks)]

        base = 1 << self.chunk_bits()
        fc = alg.zero()
        sc = alg.zero()
        for f, s in zip(reversed(first_chunks), reversed(second_chunks)):
            fc = alg.add(alg.mul_const(fc, base), f)
            sc = alg.add(alg.mul_const(sc, base), s)
        constraints.append(alg.sub(fc, first_input))
        constraints.append(alg.sub(sc, second_input))

        chunk_size = 1 << self.chunk_bits()
        msd_so_far = alg.zero()
        for i in range(self.num_chunks):
            first_product = one
            second_product = one
            for x in range(chunk_size):
                first_product = alg.mul(first_product,
                                        alg.add_const(first_chunks[i],
                                                      gl.P - x if x else 0))
                second_product = alg.mul(second_product,
                                         alg.add_const(second_chunks[i],
                                                       gl.P - x if x else 0))
            constraints.append(first_product)
            constraints.append(second_product)

            difference = alg.sub(second_chunks[i], first_chunks[i])
            equality_dummy = vars.local_wires[self.wire_equality_dummy(i)]
            chunks_equal = vars.local_wires[self.wire_chunks_equal(i)]
            constraints.append(alg.sub(alg.mul(difference, equality_dummy),
                                       alg.sub(one, chunks_equal)))
            constraints.append(alg.mul(chunks_equal, difference))

            intermediate = vars.local_wires[self.wire_intermediate_value(i)]
            constraints.append(alg.sub(intermediate,
                                       alg.mul(chunks_equal, msd_so_far)))
            msd_so_far = alg.add(intermediate,
                                 alg.mul(alg.sub(one, chunks_equal),
                                         difference))

        msd = vars.local_wires[self.wire_most_significant_diff()]
        constraints.append(alg.sub(msd, msd_so_far))
        product = one
        for x in range(chunk_size):
            product = alg.mul(product,
                              alg.add_const(msd, gl.P - x if x else 0))
        constraints.append(product)
        return constraints

    def generators(self, row, local_constants):
        return [AssertLessThanGenerator(row, self)]

    def num_wires(self):
        return self.wire_intermediate_value(self.num_chunks - 1) + 1

    def num_constants(self):
        return 0

    def degree(self):
        return 1 << self.chunk_bits()

    def num_constraints(self):
        return 4 + 5 * self.num_chunks


class AssertLessThanGenerator(SimpleGenerator):
    def __init__(self, row, gate: AssertLessThanGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        return [("w", self.row, self.gate.wire_first_input()),
                ("w", self.row, self.gate.wire_second_input())]

    def run_once(self, witness, out):
        g = self.gate
        first = witness.get_target(("w", self.row, g.wire_first_input()))
        second = witness.get_target(("w", self.row, g.wire_second_input()))
        if first > second:
            raise ValueError(f"assert_le witness violated: {first} > "
                             f"{second}")

        chunk_size = 1 << g.chunk_bits()
        fc, sc = [], []
        f, s = first, second
        for _ in range(g.num_chunks):
            fc.append(f % chunk_size)
            sc.append(s % chunk_size)
            f //= chunk_size
            s //= chunk_size

        msd_so_far = 0
        for i in range(g.num_chunks):
            equal = fc[i] == sc[i]
            dummy = 1 if equal else pow((sc[i] - fc[i]) % gl.P, gl.P - 2, gl.P)
            out.append((("w", self.row, g.wire_first_chunk_val(i)), fc[i]))
            out.append((("w", self.row, g.wire_second_chunk_val(i)), sc[i]))
            out.append((("w", self.row, g.wire_equality_dummy(i)), dummy))
            out.append((("w", self.row, g.wire_chunks_equal(i)), int(equal)))
            if not equal:
                out.append((("w", self.row, g.wire_intermediate_value(i)), 0))
                msd_so_far = (sc[i] - fc[i]) % gl.P
            else:
                out.append((("w", self.row, g.wire_intermediate_value(i)),
                            msd_so_far))
        out.append((("w", self.row, g.wire_most_significant_diff()),
                    msd_so_far))
