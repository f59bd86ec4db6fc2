"""A cyclic (IVC) Poseidon hash chain: a circuit that verifies a proof of
itself, each proof one more link of the chain (the circuit of
tests/test_cyclic_recursion.py in the JAX package; reference
recursion/cyclic_recursion.rs:238-349).

Public inputs: the initial hash (4), the chain's tip (4), the chain's
length (1), then the cycle's verifier data.  The first proof verifies a
dummy proof (condition 0) and hashes the initial hash once; each later
proof verifies the one before (condition 1) and hashes its tip.  Every
proof, the dummy ones included, goes through ProverSession on `device`
(cuda unless given).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fri.config import FriConfig, FriReductionStrategy
from ..hash import poseidon as pos
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..plonk.recursion import (common_data_for_recursion, cyclic_base_proof,
                               dummy_circuit)
from ..runtime.session import ProverSession

# the cycle's common data is padded to the power of two above 9/8 of its
# gates, which keeps the JAX package's test at 2^12 rows
HEADROOM = (9, 8)


def fast_recursion_config() -> CircuitConfig:
    """The chain's config in the JAX package's test
    (tests/test_cyclic_recursion.py:fast_recursion_config): 135 wires,
    rate 3, cap height 4, 16 bits of proof of work, 8 queries."""
    return CircuitConfig(fri_config=FriConfig(
        rate_bits=3, cap_height=4, proof_of_work_bits=16,
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
        num_query_rounds=8))


@dataclass
class CyclicHashChain:
    data: object                # the cyclic circuit's CircuitData
    common_data: object         # the cycle's CommonCircuitData
    dummy: object               # the dummy circuit of that common data
    condition: object           # 1: verify the previous link; 0: a dummy
    inner_proof: object         # ProofWithPublicInputsTarget
    verifier_data: object       # VerifierCircuitTarget (public inputs)

    def witness(self, previous, initial, device=None, rng=None):
        """The inputs of the link after `previous` (a proof of this
        circuit), or of the first link from the 4 ints `initial` when
        `previous` is None; the first link's dummy base proof is made on
        `device`."""
        pw = PartialWitness()
        if previous is None:
            pw.set_target(self.condition, 0)
            previous = cyclic_base_proof(
                self.common_data, self.data.verifier_only,
                dict(enumerate(initial)), device=device, rng=rng,
                circuit=self.dummy)
        else:
            pw.set_target(self.condition, 1)
        pw.set_proof_with_pis_target(self.inner_proof, previous)
        pw.set_verifier_data_target(self.verifier_data,
                                    self.data.verifier_only)
        return pw


def build_cyclic_hash_chain(config, device=None, rng=None,
                            timing=None) -> CyclicHashChain:
    """The cyclic circuit under `config`, committed on `device`; its
    common data padded by HEADROOM (common_data_for_recursion, under
    ``timing.scope("common data")``).  The dummy circuit is built once,
    and the dummy proof the circuit verifies at the chain's start is
    proved here (``timing.scope("dummy proof and build")``)."""
    from ..utils.timing import NoopTiming
    timing = timing if timing is not None else NoopTiming()
    b = CircuitBuilder(config)
    one = b.one()

    initial_hash = b.add_virtual_hash()
    b.register_public_inputs(initial_hash)
    current_hash_in = b.add_virtual_hash()
    current_hash_out = b.hash_n_to_hash_no_pad(list(current_hash_in))
    b.register_public_inputs(current_hash_out)
    counter = b.add_virtual_public_input()

    with timing.scope("common data"):
        common_data = common_data_for_recursion(config, *HEADROOM)
    verifier_data = b.add_verifier_data_public_inputs()
    common_data.num_public_inputs = b.num_public_inputs()

    condition = b.add_virtual_bool_target_safe()
    inner = b.add_virtual_proof_with_pis(common_data)
    inner_pis = inner.public_inputs
    b.connect_hashes(initial_hash, tuple(inner_pis[0:4]))
    actual_hash_in = b.select_hash(condition, tuple(inner_pis[4:8]),
                                   initial_hash)
    b.connect_hashes(current_hash_in, actual_hash_in)
    b.connect(counter, b.mul_add(condition, inner_pis[8], one))

    with timing.scope("dummy proof and build"):
        dummy = dummy_circuit(common_data, device)
        b.conditionally_verify_cyclic_proof_or_dummy(
            condition, inner, common_data, device=device, rng=rng,
            dummy=dummy)
        data = b.build(device=device)
    return CyclicHashChain(data, common_data, dummy, condition, inner,
                           verifier_data)


def prove_link(chain: CyclicHashChain, previous, initial, device=None,
               rng=None, timing=None):
    """The proof of the link after `previous` (None: the first link)."""
    pw = chain.witness(previous, initial, device, rng)
    return ProverSession(chain.data, device, timing=timing).prove(
        pw, rng=rng, timing=timing)


def iterate_poseidon(initial, n: int):
    """`initial` hashed n times with the host Poseidon."""
    cur = list(initial)
    for _ in range(n):
        cur = [int(x) for x in pos.hash_no_pad(np.array(cur,
                                                        dtype=np.uint64))]
    return cur
