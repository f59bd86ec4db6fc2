"""The port's whole proof against the JAX prover, on the CPU.

The fibonacci circuit (plonky2_tpu/models/fibonacci.py) is built by the
JAX package; its witness comes from the JAX host engine with the witness
randomness pinned (as tests/test_prover_session.py pins it).  The port's
``prove`` takes that witness and ``ProverData.from_circuit`` of the circuit,
and its proof, turned into the JAX package's classes by ``to_jax_proof``:

- serializes byte for byte like the JAX ``prove``'s proof;
- passes the JAX verifier;
- fails it once one opened value is changed.

Two fibonacci sizes, 99 steps (2^3 rows, no FRI fold layer) and 2000
steps (2^7 rows, one fold layer of arity 16), and the flagship circuit's
family at a small size: the hash tree of 2^5 leaves
(plonky2_tpu/models/hash_tree.py) under ``CircuitConfig.wide_ecc_config()``
(234 wires, 2^6 rows, its Poseidon gates, 16 bits of proof of work, 28
queries, one fold layer)."""
import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

import plonky2_tpu.iop.generator as gen_mod
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.fri.verifier import FriVerificationError
from plonky2_tpu.plonk.verifier import ProofVerificationError
from plonky2_tpu.utils.serialization import serialize_proof

P = jgl.P


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test of the port runs: the suite runs
    files in parallel workers, and torch's default of a thread a core in
    each worker oversubscribes the CPU; these tensors are small, so one
    thread is as fast alone.  Test files of the port import this."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax_merkle(cap=None, proof=None):
    from plonky2_tpu.hash.merkle import MerkleCap, MerkleProof
    if cap is not None:
        return MerkleCap(np.asarray(cap.digests, dtype=np.uint64))
    return MerkleProof([np.asarray(s, dtype=np.uint64)
                        for s in proof.siblings])


def to_jax_fri_proof(fp):
    """A port FriProof as the JAX package's, field by field."""
    from plonky2_tpu.fri import proof as jf
    rounds = [jf.FriQueryRound(
        initial_trees_proof=jf.FriInitialTreeProof(evals_proofs=[
            (np.asarray(v, dtype=np.uint64), to_jax_merkle(proof=m))
            for v, m in r.initial_trees_proof.evals_proofs]),
        steps=[jf.FriQueryStep(evals=np.asarray(s.evals, dtype=np.uint64),
                               merkle_proof=to_jax_merkle(
                                   proof=s.merkle_proof))
               for s in r.steps]) for r in fp.query_round_proofs]
    return jf.FriProof(
        commit_phase_merkle_caps=[to_jax_merkle(cap=c)
                                  for c in fp.commit_phase_merkle_caps],
        query_round_proofs=rounds,
        final_poly=np.asarray(fp.final_poly, dtype=np.uint64),
        pow_witness=int(fp.pow_witness))


def to_jax_proof(p):
    """A port ProofWithPublicInputs as the JAX package's."""
    from plonky2_tpu.plonk import proof as jp
    o = p.proof.openings
    openings = jp.OpeningSet(**{
        f.name: np.asarray(getattr(o, f.name), dtype=np.uint64)
        for f in dataclasses.fields(jp.OpeningSet)})
    return jp.ProofWithPublicInputs(
        proof=jp.Proof(
            wires_cap=to_jax_merkle(cap=p.proof.wires_cap),
            plonk_zs_partial_products_cap=to_jax_merkle(
                cap=p.proof.plonk_zs_partial_products_cap),
            quotient_polys_cap=to_jax_merkle(cap=p.proof.quotient_polys_cap),
            openings=openings,
            opening_proof=to_jax_fri_proof(p.proof.opening_proof)),
        public_inputs=[int(x) for x in p.public_inputs])


def pin_randomness(monkeypatch, seed: int = 0x5EED):
    """Witness randomness from a seeded stream; returns a function that
    restarts the stream."""
    rng = random.Random(seed)

    def run_once(self, witness, out):
        out.append((self.target, rng.randrange(P)))

    monkeypatch.setattr(gen_mod.RandomValueGenerator, "run_once", run_once)
    return lambda: rng.seed(seed)


@functools.lru_cache(maxsize=3)
def circuit(name: str, size: int):
    """(CircuitData, PartialWitness, ProverData): the fibonacci circuit of
    `size` steps under the fast test config, or the hash tree of 2^size
    leaves under the wide ECC config."""
    from plonky2_tpu.models.fibonacci import build_fibonacci_circuit
    from plonky2_tpu.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu.plonk.config import CircuitConfig
    from plonky2_tpu.plonk.quotient_program import build_quotient_program
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk.prover_data import ProverData
    from tests.test_plonk import fast_test_config
    if name == "fibonacci":
        data, pw, _ = build_fibonacci_circuit(fast_test_config(), steps=size)
    else:
        data, pw, _ = build_hash_tree_circuit(
            CircuitConfig.wide_ecc_config(), size)
    prog = cp.program_from_arrays(build_quotient_program(data.common))
    return data, pw, ProverData.from_circuit(data.prover_only, data.common,
                                             prog)


def jax_witness(data, pw):
    from plonky2_tpu.iop.generator import generate_partial_witness
    return generate_partial_witness(pw, data.prover_only,
                                    data.common).full_witness()


@pytest.mark.parametrize("name,size,layers", [("fibonacci", 99, 0),
                                               ("fibonacci", 2000, 1),
                                               ("hash_tree", 5, 1)])
def test_prove_is_byte_identical_and_verifies(monkeypatch, name, size,
                                              layers):
    from plonky2_tpu_torch.plonk.prover import prove
    data, pw, pd = circuit(name, size)
    assert len(pd.fri_params.reduction_arity_bits) == layers
    restart = pin_randomness(monkeypatch)
    want = data.prove(pw)
    restart()
    proof = prove(pd, jax_witness(data, pw), device="cpu")
    got = to_jax_proof(proof)
    assert serialize_proof(got) == serialize_proof(want)
    data.verify(got)

    bad = to_jax_proof(proof)
    bad.proof.openings.wires[0, 0] = (int(bad.proof.openings.wires[0, 0])
                                      + 1) % P
    with pytest.raises((ProofVerificationError, FriVerificationError)):
        data.verify(bad)


def test_prover_data_matches_common_data():
    """The carrier's ranges, FRI instance, FRI params and public-input
    cells equal what the JAX CircuitData gives."""
    from plonky2_tpu.iop.generator import generate_partial_witness
    data, pw, pd = circuit("fibonacci", 99)
    common = data.common
    for name in ("constants_range", "sigmas_range", "zs_range",
                 "partial_products_range"):
        assert getattr(pd, name)() == getattr(common, name)()
    zeta = (12345, 678)
    ours, ref = pd.get_fri_instance(zeta), common.get_fri_instance(zeta)
    assert [(o.num_polys, o.blinding) for o in ours.oracles] == \
        [(o.num_polys, o.blinding) for o in ref.oracles]
    for a, b in zip(ours.batches, ref.batches):
        assert tuple(a.point) == tuple(b.point)
        assert [(p.oracle_index, p.polynomial_index) for p in a.polynomials] \
            == [(p.oracle_index, p.polynomial_index) for p in b.polynomials]
    fp, jfp = pd.fri_params, common.fri_params
    assert fp.reduction_arity_bits == jfp.reduction_arity_bits
    assert fp.final_poly_len() == jfp.final_poly_len()
    assert fp.lde_bits() == jfp.lde_bits()
    np.testing.assert_array_equal(pd.sigmas, data.prover_only.sigmas.T)
    pwit = generate_partial_witness(pw, data.prover_only, common)
    assert pd.public_inputs(pwit.full_witness()) == \
        pwit.get_targets(data.prover_only.public_inputs)
