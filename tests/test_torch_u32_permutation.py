"""The port's U32, insertion and permutation gadgets against the JAX
package's, on the CPU.

The circuits of tests/test_insertion_waksman.py (an insertion, an
AS-Waksman permutation of chunks, memory operations sorted) and of
tests/test_u32_biguint.py::test_u32_arithmetic (models/gate_set.py's U32
block), each written once and built by both packages from the same
seeded values:

- the gates and the circuit digest equal JAX's;
- the port's CPU proof serializes byte for byte like JAX's, under the
  same witness randomness, and the port's verifier accepts it;
- a non-permutation is refused (tests/test_insertion_waksman.py:65-84);
- the quotient program of a small gate set (models/gate_set.py: every
  new gate) equals JAX's compiler output array for array, and run_plain
  equals JAX's run_numpy on random inputs.

Exact equality (field elements and bytes).
"""
import random
import types

import numpy as np
import pytest

from plonky2_tpu.gadgets import permutation as jperm
from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu.plonk.quotient_program import \
    build_quotient_program as jax_build_quotient_program
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.gadgets import permutation
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.models.gate_set import place_gate_set, place_u32_block
from plonky2_tpu_torch.plonk import constraint_program as cp
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.quotient_program import build_quotient_program
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_program_builder import _equal_arrays, _run_both
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import P, pin_randomness

JAX = types.SimpleNamespace(builder=JaxBuilder, config=JaxCircuitConfig,
                            pw=JaxPartialWitness,
                            memory_op=jperm.MemoryOpTarget)
PORT = types.SimpleNamespace(builder=CircuitBuilder, config=CircuitConfig,
                             pw=PartialWitness,
                             memory_op=permutation.MemoryOpTarget)


def rand_ext(rng):
    return (rng.randrange(P), rng.randrange(P))


def case_insert(b, pw, rng, pkg, vec_size=5):
    vec = [rand_ext(rng) for _ in range(vec_size)]
    element = rand_ext(rng)
    index = rng.randrange(vec_size + 1)
    out = b.insert(b.constant(index), b.constant_extension(element),
                   [b.constant_extension(v) for v in vec])
    expected = vec[:index] + [element] + vec[index:]
    for o, e in zip(out, expected):
        b.connect_extension(o, b.constant_extension(e))


def case_permutation(b, pw, rng, pkg, n=6, chunk=2, broken=False):
    a_vals = [tuple(rng.randrange(P) for _ in range(chunk))
              for _ in range(n)]
    perm = list(range(n))
    rng.shuffle(perm)
    b_vals = [a_vals[p] for p in perm]
    if broken:
        b_vals[0] = ((b_vals[0][0] + 1) % P,) + b_vals[0][1:]
    a_t = [[b.add_virtual_target() for _ in range(chunk)] for _ in range(n)]
    b_t = [[b.add_virtual_target() for _ in range(chunk)] for _ in range(n)]
    for chunk_t, chunk_v in zip(a_t + b_t, a_vals + b_vals):
        for t, v in zip(chunk_t, chunk_v):
            pw.set_target(t, v)
    b.assert_permutation(a_t, b_t)


def case_sort_memory_ops(b, pw, rng, pkg, n=5, address_bits=10,
                         timestamp_bits=10):
    ops_vals, seen = [], set()
    while len(ops_vals) < n:
        addr = rng.randrange(1 << address_bits)
        ts = rng.randrange(1 << timestamp_bits)
        if (addr, ts) in seen:
            continue
        seen.add((addr, ts))
        ops_vals.append((addr, ts, rng.randrange(2), rng.randrange(P)))
    ops_t = []
    for addr, ts, w, v in ops_vals:
        op = pkg.memory_op(is_write=b.add_virtual_target(),
                           address=b.add_virtual_target(),
                           timestamp=b.add_virtual_target(),
                           value=b.add_virtual_target())
        pw.set_target(op.address, addr)
        pw.set_target(op.timestamp, ts)
        pw.set_target(op.is_write, w)
        pw.set_target(op.value, v)
        ops_t.append(op)
    out = b.sort_memory_ops(ops_t, address_bits, timestamp_bits)
    for op_t, (addr, ts, w, v) in zip(out, sorted(ops_vals)):
        b.connect(op_t.address, b.constant(addr))
        b.connect(op_t.timestamp, b.constant(ts))
        b.connect(op_t.is_write, b.constant(w))
        b.connect(op_t.value, b.constant(v))


def case_u32_arithmetic(b, pw, rng, pkg):
    place_u32_block(b, pw, np.random.default_rng(rng.getrandbits(64)))


def case_every_gate(b, pw, rng, pkg):
    """A small gate set (models/gate_set.py): every new gate, for its
    quotient program."""
    place_gate_set(b, pw, pkg.memory_op, seed=rng.getrandbits(64),
                   memory_ops=5, chunks=6, inserts=1, u32_blocks=1)


# name -> (case, config)
CASES = {
    "insert": (case_insert, "standard_recursion_config"),
    "permutation": (case_permutation, "standard_recursion_config"),
    "sort memory ops": (case_sort_memory_ops, "standard_recursion_config"),
    "u32 arithmetic": (case_u32_arithmetic, "standard_ecc_config"),
}


def build(pkg, case, config, seed, **kw):
    b, pw = pkg.builder(getattr(pkg.config, config)()), pkg.pw()
    case(b, pw, random.Random(seed), pkg, **kw)
    return (b.build(device="cpu") if pkg is PORT else b.build()), pw


def _same_circuit(td, jd):
    assert [g.id() for g in td.common.gates] == \
        [g.id() for g in jd.common.gates]
    assert td.common.degree_bits() == jd.common.degree_bits()
    assert [int(x) for x in td.verifier_only.circuit_digest] == \
        [int(x) for x in jd.verifier_only.circuit_digest]


@pytest.mark.parametrize("name", list(CASES))
def test_gadget_proof_equals_jax(monkeypatch, name):
    case, config = CASES[name]
    seed = 0x1A5 + len(name)
    td, tpw = build(PORT, case, config, seed)
    jd, jpw = build(JAX, case, config, seed)
    _same_circuit(td, jd)
    proof = ProverSession(td, "cpu").prove(tpw, rng=random.Random(seed))
    pin_randomness(monkeypatch, seed)
    assert serialize_proof(proof) == jax_serialize(jd.prove(jpw))
    td.verify(proof)


def test_non_permutation_refused():
    """tests/test_insertion_waksman.py:65-84: one value of the second
    list changed; the routing refuses it in the witness."""
    td, tpw = build(PORT, case_permutation, "standard_recursion_config",
                    0x1A5, n=4, chunk=1, broken=True)
    with pytest.raises(ValueError, match="permutations of one another"):
        ProverSession(td, "cpu").prove(tpw, rng=random.Random(0))


def test_every_gate_program_equals_jax():
    td, _ = build(PORT, case_every_gate, "standard_ecc_config", 3)
    jd, _ = build(JAX, case_every_gate, "standard_ecc_config", 3)
    _same_circuit(td, jd)
    names = {type(g).__name__ for g in td.common.gates}
    assert {"U32ArithmeticGate", "U32AddManyGate", "U32SubtractionGate",
            "U32RangeCheckGate", "ComparisonGate", "AssertLessThanGate",
            "SwitchGate", "InsertionGate"} <= names
    prog = build_quotient_program(td.common)
    jprog = jax_build_quotient_program(jd.common)
    _equal_arrays(prog.arrays(), cp.program_from_arrays(jprog).arrays())
    got, want = _run_both(prog, jprog, 16, seed=3)
    np.testing.assert_array_equal(got, want)
