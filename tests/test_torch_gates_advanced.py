"""The port's recursion gate set against the JAX package's, on the CPU.

For every gate of plonky2_tpu_torch/gates/advanced.py and
gates/interpolation.py, with the parameters tests/test_gates.py gives the
JAX gates (and the interpolation gates at 2, 4 and 8 points):

- the port's ``check_gate`` (gates/testing.py) passes: the constraints'
  degree on random LDEs, and the base-field evaluation against the
  extension one;
- ``id()``, the wire and constraint counts and the degree equal JAX's;
- ``eval_unfiltered`` equals JAX's on the same random vars, on the base
  field (NumpyBatch, 16 lanes) and on the extension (ScalarExt);
- each generator writes what JAX's writes, from the same random
  dependencies.

Exact equality (field elements).
"""
import numpy as np
import pytest

from plonky2_tpu.gates import advanced as jadv
from plonky2_tpu.gates import interpolation as jint
from plonky2_tpu.plonk import algebra as jalg
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu_torch.gates import advanced as adv
from plonky2_tpu_torch.gates import interpolation as interp
from plonky2_tpu_torch.gates.testing import check_gate
from plonky2_tpu_torch.plonk import algebra
from plonky2_tpu_torch.plonk.config import CircuitConfig

P = (1 << 64) - (1 << 32) + 1
CFG = CircuitConfig.standard_recursion_config()
JCFG = JaxCircuitConfig.standard_recursion_config()

# (name, port gate, JAX gate)
GATES = [
    ("BaseSum<2>", adv.BaseSumGate(16, 2), jadv.BaseSumGate(16, 2)),
    ("BaseSum<4>", adv.BaseSumGate(8, 4), jadv.BaseSumGate(8, 4)),
    ("BaseSum<2> config", adv.BaseSumGate.new_from_config(CFG, 2),
     jadv.BaseSumGate.new_from_config(JCFG, 2)),
    ("Exponentiation", adv.ExponentiationGate(17),
     jadv.ExponentiationGate(17)),
    ("Exponentiation config", adv.ExponentiationGate.new_from_config(CFG),
     jadv.ExponentiationGate.new_from_config(JCFG)),
    ("RandomAccess 2", adv.RandomAccessGate.new_from_config(CFG, 2),
     jadv.RandomAccessGate.new_from_config(JCFG, 2)),
    ("RandomAccess 4", adv.RandomAccessGate.new_from_config(CFG, 4),
     jadv.RandomAccessGate.new_from_config(JCFG, 4)),
    ("Reducing", adv.ReducingGate(21), jadv.ReducingGate(21)),
    ("ReducingExtension", adv.ReducingExtensionGate(12),
     jadv.ReducingExtensionGate(12)),
    ("ArithmeticExtension", adv.ArithmeticExtensionGate.new_from_config(CFG),
     jadv.ArithmeticExtensionGate.new_from_config(JCFG)),
    ("MulExtension", adv.MulExtensionGate.new_from_config(CFG),
     jadv.MulExtensionGate.new_from_config(JCFG)),
    ("PoseidonMds", adv.PoseidonMdsGate(), jadv.PoseidonMdsGate()),
] + [
    (f"{kind}Interpolation {bits}",
     getattr(interp, f"{kind}DegreeInterpolationGate")(bits),
     getattr(jint, f"{kind}DegreeInterpolationGate")(bits))
    for kind in ("Low", "High") for bits in (1, 2, 3)
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


class _Witness:
    """A witness of given target values, for running one generator."""

    def __init__(self, values):
        self.values = values

    def get_target(self, t):
        return self.values[t]

    def contains(self, t):
        return t in self.values


def _dependency_values(gate, gen, rng) -> dict:
    """Random values of a generator's dependencies that its gate's
    witness allows: a sum that fits the limbs, exponent bits, an index
    in range."""
    vals = {t: int(v) for t, v in zip(gen.dependencies(),
                                      _rand(rng, len(gen.dependencies())))}
    row = 7
    if isinstance(gate, adv.BaseSumGate):
        vals[("w", row, 0)] = int(rng.integers(0, gate.base ** min(
            gate.num_limbs, 20)))
    elif isinstance(gate, adv.ExponentiationGate):
        for i in range(gate.num_power_bits):
            vals[("w", row, gate.wire_power_bit(i))] = int(rng.integers(0, 2))
    elif isinstance(gate, adv.RandomAccessGate):
        vals[("w", row, gate.wire_access_index(gen.copy))] = int(
            rng.integers(0, gate.vec_size()))
    return vals


@pytest.mark.parametrize("name,gate,jgate", GATES, ids=IDS)
def test_generators_equal_jax(name, gate, jgate):
    rng = np.random.default_rng(100 + len(name))
    consts = [int(c) for c in _rand(rng, gate.num_constants())]
    gens = gate.generators(7, consts)
    jgens = jgate.generators(7, consts)
    assert [type(g).__name__ for g in gens] == \
        [type(g).__name__ for g in jgens]
    assert gens, "every gate of the set has a generator"
    for gen, jgen in zip(gens, jgens):
        assert gen.dependencies() == jgen.dependencies()
        vals = _dependency_values(gate, gen, rng)
        out, jout = [], []
        gen.run_once(_Witness(vals), out)
        jgen.run_once(_Witness(vals), jout)
        assert out and [(t, int(v)) for t, v in out] == \
            [(t, int(v)) for t, v in jout]
