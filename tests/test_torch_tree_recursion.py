"""Tree recursion in the port against the JAX package, on the CPU.

tests/test_tree_recursion.py's tree under its fast_config (rate 3, cap
height 4, 8 queries, 16 bits of proof of work): the inner Fibonacci
circuit (models/fibonacci.py), the shared common data
``common_data_for_recursion(config, 5, 2)`` (2^14 rows), the leaf circuit
over the inner proof and the node circuit over two proofs of the common
data, each built by both packages.

A build's constants-sigmas commitment takes minutes at 2^14 rows with the
plain versions on the CPU (and JAX's common data builds three circuits
in full), so the tier-1 tests record what each package's build commits
and give it a cap of zeros (``recorded_commits``); the commitment itself
is held equal to JAX's in tests/test_torch_commit.py:

- the shared common data and the leaf and node circuits have JAX's gates
  and common data, and the leaf and node both take the shared common
  data; each build commits JAX's constants and sigmas, value for value,
  and gives JAX's digest of the same cap;
- the witness that ``set_tree_recursion_leaf_data`` makes from the inner
  proof (the port's, which JAX reads through its deserializer) equals
  JAX's, target for target, and the host engine's generated leaf witness
  carries the inner proof's public inputs hashed, the two circuit digests
  hashed and the leaf's own verifier data as the leaf's public inputs.

Built in full and proved (`heavy`, as the JAX package's tree test is):
the leaf and node circuits' digests and caps equal JAX's; two leaf
proofs and a node proof over them, each verified and checked by
``check_tree_proof_verifier_data``; the node setter's witness equals
JAX's on those proofs, and JAX's verifier accepts the node proof.

Exact equality.
"""
import contextlib
import random
import types

import numpy as np
import pytest

import plonky2_tpu.plonk.circuit_builder as jcb
from plonky2_tpu.fri.config import FriConfig as JaxFriConfig
from plonky2_tpu.fri.config import \
    FriReductionStrategy as JaxFriReductionStrategy
from plonky2_tpu.hash.merkle import MerkleCap as JaxMerkleCap
from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
from plonky2_tpu.models.fibonacci import \
    build_fibonacci_circuit as jax_fibonacci
from plonky2_tpu.plonk import tree_recursion as jtr
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu.plonk.recursion import \
    common_data_for_recursion as jax_common_data_for_recursion
from plonky2_tpu.utils.serialization import \
    deserialize_proof as jax_deserialize
import plonky2_tpu_torch.plonk.circuit_builder as cb
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.hash.merkle import MerkleCap
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.models.fibonacci import build_fibonacci_circuit
from plonky2_tpu_torch.models.recursion_tree import (build_tree,
                                                     tree_witnesses)
from plonky2_tpu_torch.plonk import tree_recursion as tr
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.recursion import common_data_for_recursion
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_recursion import torch_threads

SEED = 0x5EED
FRI = dict(rate_bits=3, cap_height=4, proof_of_work_bits=16,
           num_query_rounds=8)


def fast_config():
    return CircuitConfig(fri_config=FriConfig(
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
        **FRI))


def jax_fast_config():
    return JaxCircuitConfig(fri_config=JaxFriConfig(
        reduction_strategy=JaxFriReductionStrategy.ConstantArityBits(4, 5),
        **FRI))


@contextlib.contextmanager
def recorded_commits(module, cap_cls, record: list):
    """Each build of `module`'s CircuitBuilder appends the values it
    commits to `record` and gets a cap of zeros instead of the
    commitment."""
    def from_values(values, rate_bits, blinding, cap_height, *a, **kw):
        record.append(np.asarray(values, dtype=np.uint64))
        cap = cap_cls(np.zeros((1 << cap_height, 4), dtype=np.uint64))
        return types.SimpleNamespace(merkle_tree=types.SimpleNamespace(
            cap=cap))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module.PolynomialBatch, "from_values",
                   staticmethod(from_values))
        yield


def port_tree():
    return build_tree(CircuitBuilder, fast_config(),
                      lambda c: build_fibonacci_circuit(c, device="cpu"),
                      common_data_for_recursion,
                      lambda b: b.build(device="cpu"))


def jax_tree():
    return build_tree(JaxBuilder, jax_fast_config(), jax_fibonacci,
                      jax_common_data_for_recursion, lambda b: b.build())


def inner_proof(port):
    with torch_threads(2):
        return ProverSession(port["inner"], "cpu").prove(
            port["inner_pw"], rng=random.Random(SEED))


@pytest.fixture(scope="module")
def tree():
    """Both packages' trees, each build's commitment recorded (a cap of
    zeros); the port's inner proof, its inner circuit built in full."""
    commits, jcommits = [], []
    with torch_threads(2), recorded_commits(cb, MerkleCap, commits):
        port = port_tree()
    with recorded_commits(jcb, JaxMerkleCap, jcommits):
        jax = jax_tree()
    with torch_threads(2):
        inner, inner_pw, _ = build_fibonacci_circuit(fast_config(),
                                                     device="cpu")
    full = dict(inner=inner, inner_pw=inner_pw)
    return dict(port=port, jax=jax, commits=commits, jcommits=jcommits,
                inner_full=inner, inner_proof=inner_proof(full))


def _same_common(data, jdata):
    assert [g.id() for g in data.common.gates] == \
        [g.id() for g in jdata.common.gates]
    for f in ("degree_bits", "num_public_inputs", "num_constants",
              "quotient_degree_factor", "num_partial_products", "k_is"):
        v, jv = getattr(data.common, f), getattr(jdata.common, f)
        assert (v() if callable(v) else v) == (jv() if callable(jv) else jv)


def test_tree_circuits_equal_jax(tree):
    port, jax = tree["port"], tree["jax"]
    common, jcommon = port["common"], jax["common"]
    assert [g.id() for g in common.gates] == [g.id() for g in jcommon.gates]
    assert common.degree_bits() == jcommon.degree_bits() == 14
    for name in ("leaf", "node"):
        _same_common(port[name], jax[name])
        assert port[name].common == common
        assert [int(x) for x in port[name].verifier_only.circuit_digest] == \
            [int(x) for x in jax[name].verifier_only.circuit_digest]
    # the inner circuit, JAX's three common-data builds, the leaf, the node
    commits, jcommits = tree["commits"], tree["jcommits"]
    assert len(jcommits) == 6 and len(commits) == 3
    for got, want in zip(commits, [jcommits[0]] + jcommits[-2:]):
        np.testing.assert_array_equal(got, want)


def _leaf_witness(pkg_pw, tr_mod, tree_, proof, inner=None):
    tree_ = dict(tree_, inner=inner or tree_["inner"])
    return tree_witnesses(tree_, proof, pkg_pw, tr_mod)[0]()


def test_leaf_witness_equals_jax(tree):
    port, jax, proof = tree["port"], tree["jax"], tree["inner_proof"]
    pw = _leaf_witness(PartialWitness, tr, port, proof)
    jproof = jax_deserialize(serialize_proof(proof), jax["inner"].common)
    jpw = _leaf_witness(JaxPartialWitness, jtr, jax, jproof)
    assert pw.target_values == {t: int(v)
                                for t, v in jpw.target_values.items()}

    # the inner proof verifies in the leaf against its circuit's real data
    leaf, inner = port["leaf"], tree["inner_full"]
    pw = _leaf_witness(PartialWitness, tr, port, proof, inner)
    with torch_threads(2):
        witness = generate_partial_witness(pw, leaf.prover_only, leaf.common,
                                           rng=random.Random(SEED))
    pis = witness.get_targets(leaf.prover_only.public_inputs)
    digest = lambda vd: [int(x) for x in vd.circuit_digest]  # noqa: E731
    assert pis[0:4] == [int(x) for x in pos.hash_no_pad(
        [int(x) for x in proof.public_inputs])]
    assert pis[4:8] == [int(x) for x in pos.hash_no_pad(
        digest(inner.verifier_only) + digest(leaf.verifier_only))]
    assert pis[8:12] == digest(leaf.verifier_only)
    assert pis[12:] == leaf.verifier_only.constants_sigmas_cap.digests \
        .reshape(-1).tolist()


@pytest.mark.heavy
def test_tree_proofs():
    with torch_threads(2):
        port = port_tree()
    jax = jax_tree()
    for name in ("inner", "leaf", "node"):
        _same_common(port[name], jax[name])
        assert [int(x) for x in port[name].verifier_only.circuit_digest] == \
            [int(x) for x in jax[name].verifier_only.circuit_digest]
        assert port[name].verifier_only.constants_sigmas_cap.digests \
            .tolist() == jax[name].verifier_only.constants_sigmas_cap \
            .digests.tolist()
    leaf, node, common = port["leaf"], port["node"], port["common"]
    inner = inner_proof(port)
    proofs = []
    with torch_threads(2):
        sess = ProverSession(leaf, "cpu")
        for seed in (SEED, SEED + 1):
            proof = sess.prove(_leaf_witness(PartialWitness, tr, port, inner),
                               rng=random.Random(seed))
            leaf.verify(proof)
            tr.check_tree_proof_verifier_data(proof, leaf.verifier_only,
                                              common)
            proofs.append(proof)
        pw = tree_witnesses(port, inner)[1](*proofs)
        root = ProverSession(node, "cpu").prove(pw, rng=random.Random(SEED))
    node.verify(root)
    tr.check_tree_proof_verifier_data(root, node.verifier_only, common)
    with pytest.raises(ValueError):
        tr.check_tree_proof_verifier_data(root, leaf.verifier_only, common)

    jnode = jax["node"]
    jproofs = [jax_deserialize(serialize_proof(p), jax["leaf"].common)
               for p in proofs]
    jpw = tree_witnesses(jax, None, JaxPartialWitness, jtr)[1](*jproofs)
    assert pw.target_values == {t: int(v)
                                for t, v in jpw.target_values.items()}
    jnode.verify(jax_deserialize(serialize_proof(root), jnode.common))
