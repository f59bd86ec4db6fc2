"""Field algebras that the gates' constraints are written against.

The port's copy of plonky2_tpu/plonk/algebra.py.  One definition of each
gate's constraints (gates/*.py) runs in every domain the host layer needs:

- ``NumpyBatch``: the base field, numpy uint64 arrays (the witness
  generators' batches);
- ``ScalarBase``: the base field, python ints;
- ``ScalarExt``: the quadratic extension, pairs of python ints (the
  verifier at zeta);
- ``CircuitExtAlgebra``: extension targets, each operation a gate of a
  CircuitBuilder (the recursive verifier's constraints, in the circuit).
"""
from __future__ import annotations

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as gl


class NumpyBatch:
    """Values are numpy uint64 arrays (broadcastable); constants are
    scalars."""

    def const(self, c: int):
        return np.uint64(c % gl.P)

    def zero(self):
        return np.uint64(0)

    def one(self):
        return np.uint64(1)

    def add(self, a, b):
        return gl.add(a, b)

    def sub(self, a, b):
        return gl.sub(a, b)

    def mul(self, a, b):
        return gl.mul(a, b)

    def neg(self, a):
        return gl.neg(a)

    def add_const(self, a, c: int):
        return gl.add(a, self.const(c))

    def mul_const(self, a, c: int):
        return gl.mul(a, self.const(c))

    def exp(self, a, e: int):
        return gl.exp_u64(np.asarray(a), e)


class ScalarBase:
    """Values are python ints mod p."""

    def const(self, c: int):
        return c % gl.P

    def zero(self):
        return 0

    def one(self):
        return 1

    def add(self, a, b):
        return (a + b) % gl.P

    def sub(self, a, b):
        return (a - b) % gl.P

    def mul(self, a, b):
        return (a * b) % gl.P

    def neg(self, a):
        return (-a) % gl.P

    def add_const(self, a, c: int):
        return (a + c) % gl.P

    def mul_const(self, a, c: int):
        return (a * c) % gl.P

    def exp(self, a, e: int):
        return pow(a, e, gl.P)


class ScalarExt:
    """Values are (int, int) quadratic-extension pairs."""

    def const(self, c: int):
        return (c % gl.P, 0)

    def zero(self):
        return (0, 0)

    def one(self):
        return (1, 0)

    def add(self, a, b):
        return ge.s_add(a, b)

    def sub(self, a, b):
        return ge.s_sub(a, b)

    def mul(self, a, b):
        return ge.s_mul(a, b)

    def neg(self, a):
        return ge.s_sub((0, 0), a)

    def add_const(self, a, c: int):
        return ge.s_add(a, (c % gl.P, 0))

    def mul_const(self, a, c: int):
        return ge.s_mul(a, (c % gl.P, 0))

    def exp(self, a, e: int):
        return ge.s_exp(a, e)


class CircuitExtAlgebra:
    """Values are ExtensionTargets; each operation places gates into a
    CircuitBuilder.  Any gate's ``eval_unfiltered`` run on it is that
    gate's constraint evaluation in the circuit, which the reference
    writes by hand for each gate as ``eval_unfiltered_circuit``
    (gates/gate.rs:68)."""

    def __init__(self, builder):
        self.b = builder

    def const(self, c: int):
        return self.b.constant_extension((c % gl.P, 0))

    def zero(self):
        return self.b.zero_extension()

    def one(self):
        return self.b.one_extension()

    def add(self, a, b):
        return self.b.add_extension(a, b)

    def sub(self, a, b):
        return self.b.sub_extension(a, b)

    def mul(self, a, b):
        return self.b.mul_extension(a, b)

    def neg(self, a):
        return self.b.sub_extension(self.zero(), a)

    def add_const(self, a, c: int):
        return self.b.add_const_extension(a, c % gl.P)

    def mul_const(self, a, c: int):
        return self.b.mul_const_extension(c % gl.P, a)

    def exp(self, a, e: int):
        return self.b.exp_u64_extension(a, e)


class EvaluationVars:
    """local_constants/local_wires: lists of algebra values;
    public_inputs_hash: 4 algebra values."""

    def __init__(self, local_constants, local_wires, public_inputs_hash):
        self.local_constants = local_constants
        self.local_wires = local_wires
        self.public_inputs_hash = public_inputs_hash

    def remove_prefix(self, num_selectors: int) -> "EvaluationVars":
        return EvaluationVars(self.local_constants[num_selectors:],
                              self.local_wires, self.public_inputs_hash)
