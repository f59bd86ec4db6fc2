"""Tree recursion: proofs aggregated two at a time, each proof carrying its
circuit's verifier data in its public inputs (the port's copy of
plonky2_tpu/plonk/tree_recursion.py; reference
plonky2/src/recursion/tree_recursion.rs).

The public inputs of every leaf and node proof:
  [0..4)   the hash of the children's input hashes (the leaf's: of the
           inner proof's public inputs);
  [4..8)   the hash of the children's circuit-digest hashes and its own
           circuit digest;
  [8..]    its own verifier data (circuit digest, constants-sigmas cap).

The root proof is verified against the real verifier data; the nodes
below it are held together by the chain of digest hashes.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..gates.basic import NoopGate
from .circuit_data import CommonCircuitData
from .recursion import (check_cyclic_proof_verifier_data,
                        verifier_data_from_pis)
from .recursive_verifier import (ProofWithPublicInputsTarget,
                                 VerifierCircuitTarget)


@dataclass
class TreeRecursionNodeTarget:
    proof0: ProofWithPublicInputsTarget
    proof1: ProofWithPublicInputsTarget
    verifier_data0: VerifierCircuitTarget
    verifier_data1: VerifierCircuitTarget
    verifier_data: VerifierCircuitTarget


@dataclass
class TreeRecursionLeafTarget:
    inner_proof: ProofWithPublicInputsTarget
    inner_verifier_data: VerifierCircuitTarget
    verifier_data: VerifierCircuitTarget


class TreeRecursionGadgets:
    """Mixed into CircuitBuilder.  Do not register other public inputs
    around these calls."""

    def tree_recursion_node(self, common_data: CommonCircuitData
                            ) -> TreeRecursionNodeTarget:
        inputs_hash = self.add_virtual_hash()
        circuit_digest_hash = self.add_virtual_hash()
        self.register_public_inputs(inputs_hash)
        self.register_public_inputs(circuit_digest_hash)

        if self.verifier_data_public_input is not None:
            raise ValueError("the circuit already has verifier data in its "
                             "public inputs")
        verifier_data = self.add_verifier_data_public_inputs()
        common_data.num_public_inputs = self.num_public_inputs()

        proof0 = self.add_virtual_proof_with_pis(common_data)
        proof1 = self.add_virtual_proof_with_pis(common_data)
        d0, c0 = verifier_data_from_pis(proof0.public_inputs, common_data)
        d1, c1 = verifier_data_from_pis(proof1.public_inputs, common_data)
        verifier_data0 = VerifierCircuitTarget(constants_sigmas_cap=c0,
                                               circuit_digest=d0)
        verifier_data1 = VerifierCircuitTarget(constants_sigmas_cap=c1,
                                               circuit_digest=d1)

        h = self.hash_n_to_hash_no_pad(
            list(proof0.public_inputs[0:4]) + list(proof1.public_inputs[0:4]))
        self.connect_hashes(inputs_hash, tuple(h))
        h = self.hash_n_to_hash_no_pad(
            list(proof0.public_inputs[4:8])
            + list(verifier_data.circuit_digest)
            + list(proof1.public_inputs[4:8]))
        self.connect_hashes(circuit_digest_hash, tuple(h))

        self.verify_proof(proof0, verifier_data0, common_data)
        self.verify_proof(proof1, verifier_data1, common_data)

        while self.num_gates() < common_data.degree() // 2:
            self.add_gate(NoopGate(), [])
        for g in common_data.gates:
            self.add_gate_to_gate_set(g)
        # build() pads to the goal degree and checks the fixed point
        self.goal_common_data = common_data

        return TreeRecursionNodeTarget(proof0=proof0, proof1=proof1,
                                       verifier_data0=verifier_data0,
                                       verifier_data1=verifier_data1,
                                       verifier_data=verifier_data)

    def tree_recursion_leaf(self, inner_common_data: CommonCircuitData,
                            common_data: CommonCircuitData
                            ) -> TreeRecursionLeafTarget:
        inputs_hash = self.add_virtual_hash()
        circuit_digest_hash = self.add_virtual_hash()
        self.register_public_inputs(inputs_hash)
        self.register_public_inputs(circuit_digest_hash)

        if self.verifier_data_public_input is not None:
            raise ValueError("the circuit already has verifier data in its "
                             "public inputs")
        verifier_data = self.add_verifier_data_public_inputs()
        common_data.num_public_inputs = self.num_public_inputs()

        inner_proof = self.add_virtual_proof_with_pis(inner_common_data)
        inner_verifier_data = self.add_virtual_verifier_data(
            inner_common_data.config.fri_config.cap_height)

        h = self.hash_n_to_hash_no_pad(list(inner_proof.public_inputs))
        self.connect_hashes(inputs_hash, tuple(h))
        h = self.hash_n_to_hash_no_pad(
            list(inner_verifier_data.circuit_digest)
            + list(verifier_data.circuit_digest))
        self.connect_hashes(circuit_digest_hash, tuple(h))

        self.verify_proof(inner_proof, inner_verifier_data, inner_common_data)

        while self.num_gates() < common_data.degree() // 2:
            self.add_gate(NoopGate(), [])
        for g in common_data.gates:
            self.add_gate_to_gate_set(g)
        self.goal_common_data = common_data

        return TreeRecursionLeafTarget(inner_proof=inner_proof,
                                       inner_verifier_data=inner_verifier_data,
                                       verifier_data=verifier_data)


def set_tree_recursion_node_data(pw, target: TreeRecursionNodeTarget,
                                 proof0, proof1, verifier_data) -> None:
    """verifier_data: the node circuit's own VerifierOnlyCircuitData; the
    children's verifier data rides in their public inputs."""
    pw.set_proof_with_pis_target(target.proof0, proof0)
    pw.set_proof_with_pis_target(target.proof1, proof1)
    pw.set_verifier_data_target(target.verifier_data, verifier_data)


def set_tree_recursion_leaf_data(pw, target: TreeRecursionLeafTarget,
                                 inner_proof, inner_verifier_data,
                                 verifier_data) -> None:
    pw.set_proof_with_pis_target(target.inner_proof, inner_proof)
    pw.set_verifier_data_target(target.inner_verifier_data,
                                inner_verifier_data)
    pw.set_verifier_data_target(target.verifier_data, verifier_data)


def check_tree_proof_verifier_data(proof, verifier_data,
                                   common_data: CommonCircuitData) -> None:
    """Raises ValueError unless the proof's public inputs end with
    `verifier_data` (the cyclic chain's check)."""
    check_cyclic_proof_verifier_data(proof, verifier_data, common_data)
