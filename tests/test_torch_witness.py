"""The port's host witness generation against the JAX package's, on the
CPU.

With the same seeded stream for the random wires on both sides (the JAX
side pinned as tests/test_torch_prover.py:pin_randomness pins it, the
port's given ``rng=random.Random(seed)``), the port's batched engine and
its scalar queue give JAX's ``full_witness()`` for the hash trees under
CircuitConfig.wide_ecc_config() and the fibonacci circuit; a conflicting
input raises, and a missing input leaves generators unrun, which raises,
as in JAX.  The Poseidon gate's batch generator equals JAX's on boundary
values and both swap settings."""
import random

import numpy as np
import pytest

from plonky2_tpu.gates.poseidon_gate import \
    PoseidonGenerator as JaxPoseidonGenerator
from plonky2_tpu.iop.generator import \
    generate_partial_witness as jax_generate
from plonky2_tpu_torch.gates.poseidon_gate import PoseidonGenerator
from plonky2_tpu_torch.iop.generator import (_generate_scalar,
                                             generate_partial_witness)
from plonky2_tpu_torch.iop.witness import PartialWitness
from tests.test_torch_circuit_builder import circuits
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import P, pin_randomness

SEED = 0x5EED


def port_inputs(jax_pw) -> PartialWitness:
    pw = PartialWitness()
    for t, v in jax_pw.target_values.items():
        pw.set_target(t, v)
    return pw


@pytest.mark.parametrize("name,size", [("hash_tree", 2), ("hash_tree", 5),
                                       ("fibonacci", 99)])
def test_witness_equals_jax(monkeypatch, name, size):
    (jd, jpw, _), (td, tpw, _) = circuits(name, size)
    restart = pin_randomness(monkeypatch, SEED)
    want = jax_generate(jpw, jd.prover_only, jd.common).full_witness()
    for engine in (generate_partial_witness, _generate_scalar):
        restart()
        got = engine(tpw, td.prover_only, td.common,
                     rng=random.Random(SEED))
        np.testing.assert_array_equal(got.full_witness(), want)
    # the JAX scalar queue under the same stream agrees as well
    from plonky2_tpu.iop.generator import _generate_scalar as jax_scalar
    restart()
    np.testing.assert_array_equal(
        jax_scalar(jpw, jd.prover_only, jd.common).full_witness(), want)


def test_public_inputs_equal_jax(monkeypatch):
    (jd, jpw, jroot), (td, tpw, troot) = circuits("hash_tree", 3)
    pin_randomness(monkeypatch, SEED)
    jw = jax_generate(jpw, jd.prover_only, jd.common)
    tw = generate_partial_witness(tpw, td.prover_only, td.common,
                                  rng=random.Random(SEED))
    assert tw.get_targets(td.prover_only.public_inputs) == \
        jw.get_targets(jd.prover_only.public_inputs) == troot == jroot


def test_conflicting_input_raises():
    (_, _, _), (td, tpw, _) = circuits("hash_tree", 2)
    pw = PartialWitness()
    pw.set_target(("v", 0), 5)
    with pytest.raises(ValueError, match="conflicting"):
        pw.set_target(("v", 0), 6)
    # an input on a gate's output wire that disagrees with what the gate's
    # generator computes
    bad = port_inputs(tpw)
    out = td.prover_only.generators[-1].output_targets()[-1]
    bad.set_target(out, 12345)
    for engine in (generate_partial_witness, _generate_scalar):
        with pytest.raises(ValueError):
            engine(bad, td.prover_only, td.common, rng=random.Random(0))


def test_missing_input_leaves_generators_unrun(monkeypatch):
    (jd, jpw, _), (td, tpw, _) = circuits("hash_tree", 2)
    first = next(iter(tpw.target_values))
    missing = PartialWitness()
    for t, v in tpw.target_values.items():
        if t != first:
            missing.set_target(t, v)
    for engine in (generate_partial_witness, _generate_scalar):
        with pytest.raises(ValueError, match="weren't run"):
            engine(missing, td.prover_only, td.common, rng=random.Random(0))
    # JAX refuses the same input
    from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
    jmissing = JaxPartialWitness()
    for t, v in jpw.target_values.items():
        if t != first:
            jmissing.set_target(t, v)
    pin_randomness(monkeypatch, SEED)
    with pytest.raises(AssertionError, match="weren't run"):
        jax_generate(jmissing, jd.prover_only, jd.common)


def test_poseidon_batch_generator_equals_jax():
    rng = np.random.default_rng(7)
    boundary = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - 1],
                        dtype=np.uint64)
    dep = rng.integers(0, P, size=(300, 13), dtype=np.uint64)
    dep[:100, :12] = boundary[rng.integers(0, 5, size=(100, 12))]
    dep[:, 12] = rng.integers(0, 2, size=300)
    np.testing.assert_array_equal(PoseidonGenerator.run_batch(None, dep),
                                  JaxPoseidonGenerator.run_batch(None, dep))
    dep[0, 12] = 2
    with pytest.raises(ValueError, match="swap"):
        PoseidonGenerator.run_batch(None, dep)


@pytest.mark.parametrize("name,size", [("hash_tree", 3), ("fibonacci", 99)])
def test_witness_satisfies_every_gate_constraint(name, size):
    """Every row of the port's witness zeroes every filtered gate
    constraint, evaluated over all rows at once on the base field
    (plonk/algebra.py:NumpyBatch), with the constants read back from the
    constants-sigmas commitment's coefficients and the public inputs'
    hash."""
    from plonky2_tpu_torch.field.convert import from_u64, to_u64
    from plonky2_tpu_torch.hash.poseidon import hash_no_pad
    from plonky2_tpu_torch.ops import ntt
    from plonky2_tpu_torch.plonk.algebra import EvaluationVars, NumpyBatch
    from plonky2_tpu_torch.plonk.vanishing import evaluate_gate_constraints
    (_, _, _), (td, tpw, expected) = circuits(name, size)
    common = td.common
    wires = generate_partial_witness(tpw, td.prover_only, common,
                                     rng=random.Random(SEED)).full_witness()
    coeffs = td.prover_only.constants_sigmas_commitment.polynomials
    consts = to_u64(ntt.ntt(from_u64(coeffs[:common.num_constants])))
    alg = NumpyBatch()
    pih = [alg.const(int(h))
           for h in hash_no_pad(np.array(expected, dtype=np.uint64))]
    constraints = evaluate_gate_constraints(
        alg, common, EvaluationVars(list(consts), list(wires), pih))
    assert len(constraints) == common.num_gate_constraints
    for c in constraints:
        assert not np.broadcast_to(c, wires.shape[1:]).any()
    # row 0 holds the circuit's first gate (a Poseidon or an arithmetic
    # gate); changed wires there break one of its constraints
    wires[:, 0] = (wires[:, 0] + np.uint64(1)) % np.uint64(P)
    bad = evaluate_gate_constraints(
        alg, common, EvaluationVars(list(consts), list(wires), pih))
    assert any(np.broadcast_to(c, wires.shape[1:])[0] for c in bad)
