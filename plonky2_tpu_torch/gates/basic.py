"""The basic gates: Arithmetic, Constant, PublicInput, Noop (the port's
copy of plonky2_tpu/gates/basic.py; reference gates/arithmetic_base.rs,
constant.rs, public_input.rs, noop.rs)."""
from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..iop.generator import SimpleGenerator
from .gate import Gate


class ArithmeticGate(Gate):
    """result = c0 * x * y + c1 * z; `num_ops` slots of 4 routed wires."""

    def __init__(self, num_ops: int):
        self.n_ops = num_ops

    @staticmethod
    def new_from_config(config) -> "ArithmeticGate":
        return ArithmeticGate(config.num_routed_wires // 4)

    @staticmethod
    def wire_ith_multiplicand_0(i):
        return 4 * i

    @staticmethod
    def wire_ith_multiplicand_1(i):
        return 4 * i + 1

    @staticmethod
    def wire_ith_addend(i):
        return 4 * i + 2

    @staticmethod
    def wire_ith_output(i):
        return 4 * i + 3

    def id(self):
        return f"ArithmeticGate {{ num_ops: {self.n_ops} }}"

    def eval_unfiltered(self, alg, vars):
        c0 = vars.local_constants[0]
        c1 = vars.local_constants[1]
        out = []
        for i in range(self.n_ops):
            m0 = vars.local_wires[self.wire_ith_multiplicand_0(i)]
            m1 = vars.local_wires[self.wire_ith_multiplicand_1(i)]
            addend = vars.local_wires[self.wire_ith_addend(i)]
            output = vars.local_wires[self.wire_ith_output(i)]
            computed = alg.add(alg.mul(alg.mul(m0, m1), c0),
                               alg.mul(addend, c1))
            out.append(alg.sub(output, computed))
        return out

    def generators(self, row, local_constants):
        return [ArithmeticBaseGenerator(row, int(local_constants[0]),
                                        int(local_constants[1]), i)
                for i in range(self.n_ops)]

    def num_wires(self):
        return self.n_ops * 4

    def num_constants(self):
        return 2

    def degree(self):
        return 3

    def num_constraints(self):
        return self.n_ops

    def num_ops(self):
        return self.n_ops


class ArithmeticBaseGenerator(SimpleGenerator):
    batch_group = "arithmetic_base"

    def __init__(self, row, const_0, const_1, i):
        self.row = row
        self.const_0 = const_0
        self.const_1 = const_1
        self.i = i

    def dependencies(self):
        return [("w", self.row, ArithmeticGate.wire_ith_multiplicand_0(self.i)),
                ("w", self.row, ArithmeticGate.wire_ith_multiplicand_1(self.i)),
                ("w", self.row, ArithmeticGate.wire_ith_addend(self.i))]

    def output_targets(self):
        return [("w", self.row, ArithmeticGate.wire_ith_output(self.i))]

    @classmethod
    def run_batch(cls, gens, dep_vals):
        c0 = np.array([g.const_0 for g in gens], dtype=np.uint64)
        c1 = np.array([g.const_1 for g in gens], dtype=np.uint64)
        m0, m1, ad = dep_vals[:, 0], dep_vals[:, 1], dep_vals[:, 2]
        val = gl.add(gl.mul(gl.mul(m0, m1), c0), gl.mul(ad, c1))
        return val[:, None]

    @classmethod
    def device_meta(cls, gens):
        return np.array([[g.const_0 for g in gens],
                         [g.const_1 for g in gens]], dtype=np.uint64)

    @classmethod
    def run_batch_device(cls, meta, values, dep, out, err):
        from ..field import gf
        m0, m1, ad = values[dep]
        values[out[0]] = gf.add(gf.mul(gf.mul(m0, m1), meta[0]),
                                gf.mul(ad, meta[1]))

    def run_once(self, witness, out):
        m0, m1, addend = witness.get_targets(self.dependencies())
        val = (m0 * m1 % gl.P * self.const_0 + addend * self.const_1) % gl.P
        out.append((self.output_targets()[0], val))


class ConstantGate(Gate):
    """Routes `num_consts` circuit constants to routed wires."""

    def __init__(self, num_consts: int):
        self.num_consts = num_consts

    def id(self):
        return f"ConstantGate {{ num_consts: {self.num_consts} }}"

    def const_input(self, i):
        return i

    def wire_output(self, i):
        return i

    def eval_unfiltered(self, alg, vars):
        return [alg.sub(vars.local_constants[self.const_input(i)],
                        vars.local_wires[self.wire_output(i)])
                for i in range(self.num_consts)]

    def num_wires(self):
        return self.num_consts

    def num_constants(self):
        return self.num_consts

    def degree(self):
        return 1

    def num_constraints(self):
        return self.num_consts

    def extra_constant_wires(self):
        return [(self.const_input(i), self.wire_output(i))
                for i in range(self.num_consts)]


class PublicInputGate(Gate):
    """Ties wires 0..4 to the public-inputs hash."""

    def id(self):
        return "PublicInputGate"

    @staticmethod
    def wires_public_inputs_hash() -> range:
        return range(4)

    def eval_unfiltered(self, alg, vars):
        return [alg.sub(vars.local_wires[w], vars.public_inputs_hash[i])
                for i, w in enumerate(self.wires_public_inputs_hash())]

    def num_wires(self):
        return 4

    def num_constants(self):
        return 0

    def degree(self):
        return 1

    def num_constraints(self):
        return 4


class NoopGate(Gate):
    def id(self):
        return "NoopGate"

    def eval_unfiltered(self, alg, vars):
        return []

    def num_wires(self):
        return 0

    def num_constants(self):
        return 0

    def degree(self):
        return 0

    def num_constraints(self):
        return 0
