"""The port's device witness plan (iop/device_witness.py) against its host
engine and the JAX package's plan, on the CPU (each wave's plain version;
tests/test_torch_cuda.py runs the plan on the card).

Mirrors tests/test_device_witness.py:

- the plan's wires and public inputs equal the host engine's for hash
  trees of 2^2 and 2^5 leaves under CircuitConfig.wide_ecc_config()
  (Constant and Poseidon waves) and the fibonacci circuit under the fast
  test config (Constant, ArithmeticBase and Poseidon waves), and JAX's
  ``build_plan(...).run`` for the tree of 2^3 leaves;
- one ``random.Random(seed)`` gives the host engine's witness (the random
  wires are drawn in its order), on a zk circuit whose blinding
  RandomValueGenerators join the inputs too (and whose blinding copies
  make Copy waves);
- a changed input target set raises _PlanMismatch;
- a circuit with two writers of one slot gets no plan; conflicting values
  raise on both paths, and equal ones prove through the host engine;
- a swap wire of 2 raises on both engines;
- ProverSession.prove goes through the plan, and its proof serializes
  byte for byte like the host engine's witness proved and like JAX's."""
import contextlib
import dataclasses
import random

import numpy as np
import pytest

from plonky2_tpu.field import gf_jax as jgf
from plonky2_tpu.iop.device_witness import build_plan as jax_build_plan
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.field.convert import to_u64
from plonky2_tpu_torch.iop.device_witness import (_PlanMismatch, _WaveRun,
                                                  build_plan, get_plan)
from plonky2_tpu_torch.iop.generator import (ConstantGenerator,
                                             generate_partial_witness)
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.plonk.prover import prove
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_circuit_builder import circuits, port_fast_test_config
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import pin_randomness

SEED = 0x5EED


class Stages:
    """A prover ``timing`` that records the stages' names."""

    def __init__(self):
        self.names = []

    @contextlib.contextmanager
    def scope(self, name):
        self.names.append(name)
        yield


def plan_and_host(data, pw, seed):
    """(plan, its wires as uint64, its public inputs, the host engine's
    PartitionWitness), both from random.Random(seed)."""
    plan = build_plan(data.prover_only, data.common, pw, "cpu")
    assert plan is not None
    wires, pis = plan.run(pw, random.Random(seed))
    assert wires.device.type == "cpu"
    assert tuple(wires.shape) == (data.common.config.num_wires,
                                  data.common.degree())
    host = generate_partial_witness(pw, data.prover_only, data.common,
                                    rng=random.Random(seed))
    return plan, to_u64(wires), pis, host


@pytest.mark.parametrize("name,size,classes", [
    ("hash_tree", 2, {"ConstantGenerator", "PoseidonGenerator"}),
    ("hash_tree", 5, {"ConstantGenerator", "PoseidonGenerator"}),
    ("fibonacci", 99, {"ConstantGenerator", "ArithmeticBaseGenerator",
                       "PoseidonGenerator"})])
def test_plan_witness_equals_host_engine(name, size, classes):
    (_, _, _), (td, tpw, expected) = circuits(name, size)
    plan, wires, pis, host = plan_and_host(td, tpw, SEED)
    assert {w.cls.__name__ for w in plan.waves} == classes
    # every maximal run of Poseidon waves is one step (one K7 launch on a
    # card), its index arrays side by side; the other waves step alone
    expanded = []
    for s in plan.steps:
        if isinstance(s, _WaveRun):
            assert s.dep.shape[1] == s.out.shape[1] == s.offsets[-1]
            expanded += [s.cls] * (len(s.offsets) - 1)
        else:
            expanded.append(s.cls)
    assert expanded == [w.cls for w in plan.waves]
    assert not any(isinstance(a, _WaveRun) and isinstance(b, _WaveRun)
                   and a.cls is b.cls
                   for a, b in zip(plan.steps, plan.steps[1:]))
    if name == "hash_tree":     # the Constant wave, then one run
        assert [type(s) for s in plan.steps][1:] == [_WaveRun]
    np.testing.assert_array_equal(wires, host.full_witness())
    assert pis == host.get_targets(td.prover_only.public_inputs) == expected


def test_plan_witness_equals_jax_plan(monkeypatch):
    """The port's plan and JAX's, under one seeded stream of random
    wires, give the same wires and public inputs (the tree of 2^3
    leaves; JAX's plan compiles for ~15 s on a CPU)."""
    (jd, jpw, jexp), (td, tpw, texp) = circuits("hash_tree", 3)
    pin_randomness(monkeypatch, SEED)
    jplan = jax_build_plan(jd.prover_only, jd.common, jpw)
    (lo, hi), jpis = jplan.run(jpw)
    want = jgf.to_u64((np.asarray(lo), np.asarray(hi)))
    _, wires, pis, _ = plan_and_host(td, tpw, SEED)
    np.testing.assert_array_equal(wires, want)
    assert pis == jpis == texp == jexp


def small_zk_tree():
    """The hash tree of 2^2 leaves under wide_ecc_config with zero
    knowledge and 4 FRI queries (few blinding rows; the JAX test's
    circuit)."""
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    small_fri = FriConfig(
        rate_bits=3, cap_height=2, proof_of_work_bits=4,
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
        num_query_rounds=4)
    config = dataclasses.replace(CircuitConfig.wide_ecc_config(),
                                 zero_knowledge=True, fri_config=small_fri)
    return build_hash_tree_circuit(config, 2, device="cpu")


def test_zk_plan_draws_the_host_engines_random_wires():
    """A zk circuit's blinding RandomValueGenerators draw from the
    caller's rng before the waves, in the host engine's order: one seed
    gives one witness on both engines, another seed another."""
    data, pw, root = small_zk_tree()
    plan, wires, pis, host = plan_and_host(data, pw, 7)
    n_random = len(plan._prefix_gens)
    assert n_random > data.common.config.num_wires   # blinding rows too
    assert "CopyGenerator" in {w.cls.__name__ for w in plan.waves}
    np.testing.assert_array_equal(wires, host.full_witness())
    assert pis == root
    again, _ = plan.run(pw, random.Random(7))
    np.testing.assert_array_equal(to_u64(again), wires)
    other, _ = plan.run(pw, random.Random(8))
    assert (to_u64(other) != wires).sum() >= n_random


def test_plan_rejects_changed_target_set():
    (_, _, _), (td, tpw, _) = circuits("hash_tree", 2)
    plan = get_plan(td.prover_only, td.common, tpw, "cpu")
    assert plan is not None and plan.matches(tpw)
    other = PartialWitness()
    for t, v in list(tpw.target_values.items())[:-1]:
        other.set_target(t, v)          # one target fewer
    assert not plan.matches(other)
    with pytest.raises(_PlanMismatch):
        plan.run(other)


@pytest.fixture(scope="module")
def two_writers():
    """Two products whose outputs are connected: both write one slot.
    (JAX data, port data, a, b) under the fast test config."""
    from plonky2_tpu.plonk.circuit_builder import \
        CircuitBuilder as JaxCircuitBuilder
    from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder

    from tests.test_plonk import fast_test_config
    built = []
    for builder in (JaxCircuitBuilder(fast_test_config()),
                    CircuitBuilder(port_fast_test_config())):
        a = builder.add_virtual_target()
        b = builder.add_virtual_target()
        c1 = builder.mul(a, a)
        c2 = builder.mul(b, b)
        builder.connect(c1, c2)
        builder.register_public_input(c1)
        built.append(builder.build() if not built
                     else builder.build(device="cpu"))
    return built[0], built[1], a, b


def two_writer_inputs(a, b, a_val, b_val, cls=PartialWitness):
    pw = cls()
    pw.set_target(a, a_val)
    pw.set_target(b, b_val)
    return pw


def test_multi_writer_circuit_refuses_device_plan(two_writers):
    _, td, a, b = two_writers
    assert build_plan(td.prover_only, td.common,
                      two_writer_inputs(a, b, 2, 2), "cpu") is None


def test_conflicting_writes_fail_loudly_on_both_paths(two_writers):
    jd, td, a, b = two_writers
    pw = two_writer_inputs(a, b, 2, 3)         # 4 != 9
    with pytest.raises(ValueError, match="conflict"):
        generate_partial_witness(pw, td.prover_only, td.common,
                                 rng=random.Random(0))
    sess = ProverSession(td, device="cpu")
    with pytest.raises(ValueError, match="conflict"):
        sess.prove(pw, rng=random.Random(0))


def test_equal_duplicate_writes_prove_through_the_host_engine(
        two_writers, monkeypatch):
    from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
    jd, td, a, b = two_writers
    pin_randomness(monkeypatch, SEED)
    want = jax_serialize(jd.prove(two_writer_inputs(a, b, 2, 2,
                                                    JaxPartialWitness)))
    sess = ProverSession(td, device="cpu")
    stages = Stages()
    proof = sess.prove(two_writer_inputs(a, b, 2, 2), rng=random.Random(SEED),
                       timing=stages)
    assert "witness" in stages.names and "device witness" not in stages.names
    assert proof.public_inputs == [4]
    sess.verify(proof)
    assert serialize_proof(proof) == want


def test_swap_wire_of_two_raises_on_both_engines(monkeypatch):
    """The tree's swap wires are the circuit's one constant (0); made 2,
    both engines raise."""
    (_, _, _), (td, tpw, _) = circuits("hash_tree", 2)
    const = [g for g in td.prover_only.generators
             if isinstance(g, ConstantGenerator)]
    assert len(const) == 1
    monkeypatch.setattr(const[0], "constant", 2)
    plan = build_plan(td.prover_only, td.common, tpw, "cpu")
    with pytest.raises(ValueError, match="swap"):
        plan.run(tpw, random.Random(0))
    with pytest.raises(ValueError, match="swap"):
        generate_partial_witness(tpw, td.prover_only, td.common,
                                 rng=random.Random(0))


def test_session_proves_through_the_plan(monkeypatch):
    """The session's witness is the plan's ("device witness"; the plan is
    built once, as "witness plan"), and its proof is byte for byte the
    host engine's witness proved, and JAX's proof."""
    (jd, jpw, _), (td, tpw, texp) = circuits("hash_tree", 2)
    monkeypatch.delattr(td.prover_only, "_device_witness_plans",
                        raising=False)     # no plan of an earlier test
    pin_randomness(monkeypatch, SEED)
    want = jax_serialize(jd.prove(jpw))
    sess = ProverSession(td, device="cpu")
    stages = Stages()
    proof = sess.prove(tpw, rng=random.Random(SEED), timing=stages)
    assert stages.names[:2] == ["witness plan", "device witness"]
    assert "witness" not in stages.names
    assert proof.public_inputs == texp
    blob = serialize_proof(proof)
    assert blob == want
    host = sess.witness(tpw, rng=random.Random(SEED))
    assert serialize_proof(prove(sess.prover_data, host,
                                 context=sess.context,
                                 device="cpu")) == blob
    stages = Stages()
    sess.prove(tpw, rng=random.Random(SEED), timing=stages)
    assert "witness plan" not in stages.names    # the plan is kept
    assert "device witness" in stages.names
