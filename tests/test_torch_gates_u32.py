"""The port's U32, comparison and permutation gate set against the JAX
package's, on the CPU.

For every gate of plonky2_tpu_torch/gates/{u32_gates,assert_le,switch,
insertion}.py, with the parameters tests/test_gates.py gives the JAX u32
gates and the ones the JAX package's gadgets place under
standard_ecc_config and standard_recursion_config:

- the port's ``check_gate`` (gates/testing.py) passes: the constraints'
  degree on random LDEs, and the base-field evaluation against the
  extension one;
- ``id()``, the wire and constraint counts and the degree equal JAX's;
- ``eval_unfiltered`` equals JAX's on the same random vars, on the base
  field (NumpyBatch, 16 lanes) and on the extension (ScalarExt);
- its circuit form (``eval_unfiltered`` on CircuitExtAlgebra, as the
  recursive verifier emits it) places the gates, constants and copy
  constraints JAX's places, and returns the same targets;
- each generator writes what JAX's writes, from the same random
  dependencies that the gate's witness allows (the switch's both ways).

Exact equality (field elements).
"""
import random

import numpy as np
import pytest

from plonky2_tpu.gates import assert_le as jle
from plonky2_tpu.gates import insertion as jins
from plonky2_tpu.gates import switch as jsw
from plonky2_tpu.gates import u32_gates as ju32
from plonky2_tpu.plonk import algebra as jalg
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu_torch.gates import assert_le, insertion, switch, u32_gates
from plonky2_tpu_torch.gates.testing import check_gate
from plonky2_tpu_torch.plonk import algebra
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from tests.test_torch_prover import one_torch_thread  # noqa: F401

P = (1 << 64) - (1 << 32) + 1
REC, JREC = (CircuitConfig.standard_recursion_config(),
             JaxCircuitConfig.standard_recursion_config())
ECC, JECC = (CircuitConfig.standard_ecc_config(),
             JaxCircuitConfig.standard_ecc_config())


def _pair(name, make):
    """(name, port gate, JAX gate) from `make(module, config)`."""
    return name, make(*_PORT), make(*_JAX)


_PORT = ({"u32": u32_gates, "le": assert_le, "sw": switch, "ins": insertion},
         {"rec": REC, "ecc": ECC})
_JAX = ({"u32": ju32, "le": jle, "sw": jsw, "ins": jins},
        {"rec": JREC, "ecc": JECC})

GATES = [
    _pair("U32Arithmetic ecc", lambda m, c: m["u32"].U32ArithmeticGate
          .new_from_config(c["ecc"])),
    _pair("U32Arithmetic rec", lambda m, c: m["u32"].U32ArithmeticGate
          .new_from_config(c["rec"])),
    _pair("U32AddMany 11", lambda m, c: m["u32"].U32AddManyGate
          .new_from_config(c["rec"], 11)),
    _pair("U32AddMany 10 ecc", lambda m, c: m["u32"].U32AddManyGate
          .new_from_config(c["ecc"], 10)),
    _pair("U32Subtraction", lambda m, c: m["u32"].U32SubtractionGate
          .new_from_config(c["ecc"])),
    _pair("U32RangeCheck 4", lambda m, c: m["u32"].U32RangeCheckGate(4)),
    _pair("Comparison 32/16", lambda m, c: m["u32"].ComparisonGate(32, 16)),
    _pair("AssertLessThan 32/11", lambda m, c: m["le"].AssertLessThanGate(
        32, 11)),
    _pair("AssertLessThan 20/7", lambda m, c: m["le"].AssertLessThanGate(
        20, 7)),
    _pair("Switch 1", lambda m, c: m["sw"].SwitchGate.new_from_config(
        c["rec"], 1)),
    _pair("Switch 2 ecc", lambda m, c: m["sw"].SwitchGate.new_from_config(
        c["ecc"], 2)),
    _pair("Switch 4 ecc", lambda m, c: m["sw"].SwitchGate.new_from_config(
        c["ecc"], 4)),
    _pair("Insertion 5", lambda m, c: m["ins"].InsertionGate(5)),
    _pair("Insertion 16", lambda m, c: m["ins"].InsertionGate(16)),
]
IDS = [g[0] for g in GATES]


def _rand(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("name,gate,jgate", GATES, ids=IDS)
def test_check_gate(name, gate, jgate):
    check_gate(gate)


@pytest.mark.parametrize("name,gate,jgate", GATES, ids=IDS)
def test_gate_shape_and_id_equal_jax(name, gate, jgate):
    assert gate.id() == jgate.id()
    for f in ("num_wires", "num_constants", "degree", "num_constraints",
              "num_ops", "extra_constant_wires"):
        assert getattr(gate, f)() == getattr(jgate, f)(), f


@pytest.mark.parametrize("name,gate,jgate", GATES, ids=IDS)
def test_eval_unfiltered_equals_jax(name, gate, jgate):
    rng = np.random.default_rng(len(name))
    nw, nc = gate.num_wires(), gate.num_constants()
    wires, consts, pih = (_rand(rng, (nw, 16)), _rand(rng, (nc, 16)),
                          _rand(rng, (4,)))

    def batch(g, mod):
        return g.eval_unfiltered(mod.NumpyBatch(), mod.EvaluationVars(
            list(consts), list(wires), [np.uint64(x) for x in pih]))

    got, want = batch(gate, algebra), batch(jgate, jalg)
    assert len(got) == len(want) == gate.num_constraints()
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            np.broadcast_to(np.asarray(a, np.uint64), (16,)),
            np.broadcast_to(np.asarray(b, np.uint64), (16,)), err_msg=str(k))

    ext = lambda a: [(int(x), int(y)) for x, y in a]  # noqa: E731
    ew, ec, ep = (ext(_rand(rng, (nw, 2))), ext(_rand(rng, (nc, 2))),
                  ext(_rand(rng, (4, 2))))
    got = gate.eval_unfiltered(algebra.ScalarExt(),
                               algebra.EvaluationVars(ec, ew, ep))
    want = jgate.eval_unfiltered(jalg.ScalarExt(),
                                 jalg.EvaluationVars(ec, ew, ep))
    assert [tuple(map(int, c)) for c in got] == \
        [tuple(map(int, c)) for c in want]


@pytest.mark.parametrize("name,gate,jgate", GATES, ids=IDS)
def test_circuit_form_equals_jax(name, gate, jgate):
    """The constraints emitted as gates in a circuit (the recursive
    verifier's form), over virtual extension targets."""
    def emit(g, builder, mod):
        ets = lambda n: builder.add_virtual_extension_targets(n)  # noqa
        vars = mod.EvaluationVars(ets(g.num_constants()), ets(g.num_wires()),
                                  ets(4))
        return g.eval_unfiltered(mod.CircuitExtAlgebra(builder), vars)

    b, jb = CircuitBuilder(REC), JaxBuilder(JREC)
    got, want = emit(gate, b, algebra), emit(jgate, jb, jalg)
    assert got == want
    assert [(i.gate.id(), list(i.constants)) for i in b.gate_instances] == \
        [(i.gate.id(), list(i.constants)) for i in jb.gate_instances]
    assert b.copy_constraints == jb.copy_constraints
    assert len(b.gate_instances) > 0


class _Witness:
    """A witness of given target values, for running one generator."""

    def __init__(self, values):
        self.values = values

    def get_target(self, t):
        return self.values[t]

    def get_targets(self, ts):
        return [self.values[t] for t in ts]

    def contains(self, t):
        return t in self.values


def _dependency_values(gate, gen, rng: random.Random) -> dict:
    """Random values of a generator's dependencies that its gate's
    witness allows: u32 operands, a borrow bit, ordered comparands, an
    index in range."""
    deps = gen.dependencies()
    vals = {t: rng.randrange(P) for t in deps}
    row = 7
    w = lambda c: ("w", row, c)  # noqa: E731
    if isinstance(gate, (u32_gates.U32ArithmeticGate,
                         u32_gates.U32AddManyGate,
                         u32_gates.U32RangeCheckGate)):
        vals = {t: rng.randrange(1 << 32) for t in deps}
    elif isinstance(gate, u32_gates.U32SubtractionGate):
        vals = {t: rng.randrange(1 << 32) for t in deps}
        vals[w(gate.wire_ith_input_borrow(gen.i))] = rng.randrange(2)
    elif isinstance(gate, (u32_gates.ComparisonGate,
                           assert_le.AssertLessThanGate)):
        a, b = sorted(rng.randrange(1 << gate.num_bits) for _ in range(2))
        if rng.randrange(2) and isinstance(gate, u32_gates.ComparisonGate):
            a, b = b, a
        vals[w(gate.wire_first_input())] = a
        vals[w(gate.wire_second_input())] = b
    elif isinstance(gate, insertion.InsertionGate):
        vals[w(gate.wires_insertion_index())] = rng.randrange(
            gate.vec_size + 1)
    return vals


@pytest.mark.parametrize("name,gate,jgate", GATES, ids=IDS)
def test_generators_equal_jax(name, gate, jgate):
    rng = random.Random(100 + len(name))
    gens = gate.generators(7, [])
    jgens = jgate.generators(7, [])
    assert [type(g).__name__ for g in gens] == \
        [type(g).__name__ for g in jgens]
    assert gens, "every gate of the set has a generator"
    for gen, jgen in zip(gens, jgens):
        if isinstance(gate, switch.SwitchGate):
            _check_switch_generator(gate, gen, jgen, rng)
            continue
        assert gen.dependencies() == jgen.dependencies()
        vals = _dependency_values(gate, gen, rng)
        out, jout = [], []
        gen.run_once(_Witness(vals), out)
        jgen.run_once(_Witness(vals), jout)
        assert out and [(t, int(v)) for t, v in out] == \
            [(t, int(v)) for t, v in jout]


def _check_switch_generator(gate, gen, jgen, rng):
    """Both ways: from the inputs and the switch bit to the outputs, and
    from the inputs and the outputs to the switch bit; a pair of outputs
    that is no swap of the inputs raises."""
    assert gen.watch_list() == jgen.watch_list()
    c, n = gen.copy, gate.chunk_size
    w = lambda f, e: ("w", 7, f(c, e))  # noqa: E731
    first = [rng.randrange(P) for _ in range(n)]
    second = [rng.randrange(P) for _ in range(n)]
    ins = {w(gate.wire_first_input, e): first[e] for e in range(n)}
    ins.update({w(gate.wire_second_input, e): second[e] for e in range(n)})
    bit = ("w", 7, gate.wire_switch_bool(c))
    for swap in (0, 1):
        vals = {**ins, bit: swap}
        out, jout = [], []
        assert gen.run(_Witness(vals), out) and jgen.run(_Witness(vals), jout)
        assert out == jout
        derived = {**ins, **dict(out)}
        back, jback = [], []
        assert gen.run(_Witness(derived), back)
        assert jgen.run(_Witness(derived), jback)
        assert back == jback == [(bit, swap)]
    assert not gen.run(_Witness({}), [])
    bad = {**ins, **{w(gate.wire_first_output, e): rng.randrange(P)
                     for e in range(n)}}
    bad.update({w(gate.wire_second_output, e): first[e] for e in range(n)})
    with pytest.raises(ValueError, match="No permutation"):
        gen.run(_Witness(bad), [])
