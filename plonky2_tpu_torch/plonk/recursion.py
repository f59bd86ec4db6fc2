"""Conditional and cyclic recursion, and dummy circuits (the port's copy
of plonky2_tpu/plonk/recursion.py; reference plonky2/src/recursion/
{conditional_recursive_verifier,cyclic_recursion,dummy_circuit}.rs).

Cyclic recursion lets a circuit verify proofs of itself: its verifier data
is registered as public inputs, the inner proof's claimed verifier data is
connected to them, and a dummy proof starts the chain.

The JAX package proves with ``CircuitData.prove``; the port proves through
runtime/session.py:ProverSession on a device.  So every function here that
proves or builds takes ``device`` (cuda unless given), and a builder that
verifies a dummy proof proves it on the device given to
``conditionally_verify_cyclic_proof_or_dummy``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..gadgets.merkle import HashOutTarget
from ..iop.generator import SimpleGenerator
from ..iop.witness import PartialWitness
from ..runtime.session import ProverSession
from ..utils.bits import log2_ceil
from .recursive_verifier import (FriProofTarget, OpeningSetTarget,
                                 ProofTarget, ProofWithPublicInputsTarget,
                                 VerifierCircuitTarget)


# -- dummy circuits (reference dummy_circuit.rs) ------------------------------

def dummy_circuit(common_data, device=None):
    """A circuit whose CommonCircuitData is `common_data`, committed on
    `device`."""
    from ..gates.basic import NoopGate
    from .circuit_builder import CircuitBuilder
    config = common_data.config
    if config.zero_knowledge:
        raise ValueError("Degree calculation can be off if zero-knowledge "
                         "is on.")

    degree = common_data.degree()
    num_noop_gates = degree - -(-common_data.num_public_inputs // 8) - 2

    builder = CircuitBuilder(config)
    for _ in range(num_noop_gates):
        builder.add_gate(NoopGate(), [])
    for gate in common_data.gates:
        builder.add_gate_to_gate_set(gate)
    for _ in range(common_data.num_public_inputs):
        builder.add_virtual_public_input()

    circuit = builder.build(device=device)
    if circuit.common != common_data:
        raise ValueError("dummy circuit common data does not match")
    return circuit


def dummy_proof(circuit, nonzero_public_inputs: Dict[int, int], device=None,
                rng=None):
    pw = PartialWitness()
    for i, t in enumerate(circuit.prover_only.public_inputs):
        pw.set_target(t, nonzero_public_inputs.get(i, 0))
    return ProverSession(circuit, device).prove(pw, rng=rng)


def cyclic_base_proof(common_data, verifier_data,
                      nonzero_public_inputs: Optional[Dict[int, int]] = None,
                      device=None, rng=None, circuit=None):
    """The proof that starts a cyclic chain: a dummy proof whose public
    inputs carry the cycle's verifier data; `circuit` is the dummy circuit
    of `common_data` where the caller has built it."""
    pis = dict(nonzero_public_inputs or {})
    pis_len = common_data.num_public_inputs
    cap_elements = common_data.config.fri_config.num_cap_elements()
    start_vk = pis_len - 4 - 4 * cap_elements

    digest = np.asarray(verifier_data.circuit_digest,
                        dtype=np.uint64).reshape(4)
    for j in range(4):
        pis[start_vk + j] = int(digest[j])
    cap = verifier_data.constants_sigmas_cap.digests.reshape(-1, 4)
    for i in range(cap_elements):
        for j in range(4):
            pis[start_vk + 4 + 4 * i + j] = int(cap[i][j])

    if circuit is None:
        circuit = dummy_circuit(common_data, device)
    return dummy_proof(circuit, pis, device, rng)


class DummyProofGenerator(SimpleGenerator):
    def __init__(self, proof_target, proof, verifier_data_target,
                 verifier_data):
        self.proof_target = proof_target
        self.proof = proof
        self.verifier_data_target = verifier_data_target
        self.verifier_data = verifier_data

    def dependencies(self):
        return []

    def run_once(self, witness, out):
        pw = PartialWitness()
        pw.set_proof_with_pis_target(self.proof_target, self.proof)
        pw.set_verifier_data_target(self.verifier_data_target,
                                    self.verifier_data)
        out.extend(pw.target_values.items())


# -- verifier data from public inputs (reference cyclic_recursion.rs:16-66) --

def verifier_data_from_pis(pis: List, common_data):
    """Split [..., circuit_digest (4), constants_sigmas_cap (4 * cap)] off
    the tail of a public-input list, of targets or of values."""
    cap_len = common_data.config.fri_config.num_cap_elements()
    n = len(pis)
    if n < 4 + 4 * cap_len:
        raise ValueError("Not enough public inputs")
    cap = [tuple(pis[n - 4 * (cap_len - i) + j] for j in range(4))
           for i in range(cap_len)]
    digest = tuple(pis[n - 4 - 4 * cap_len + i] for i in range(4))
    return digest, cap


def check_cyclic_proof_verifier_data(proof_with_pis, verifier_data,
                                     common_data) -> None:
    """Raises ValueError unless the proof's public inputs end with
    `verifier_data`."""
    digest, cap = verifier_data_from_pis(proof_with_pis.public_inputs,
                                         common_data)
    vd_digest = tuple(int(x) for x in
                      np.asarray(verifier_data.circuit_digest).reshape(4))
    vd_cap = [tuple(int(x) for x in row) for row in
              verifier_data.constants_sigmas_cap.digests.reshape(-1, 4)]
    if tuple(int(x) for x in digest) != vd_digest:
        raise ValueError("cyclic proof's circuit digest does not match "
                         "verifier data")
    if [tuple(int(x) for x in h) for h in cap] != vd_cap:
        raise ValueError("cyclic proof's constants/sigmas cap does not "
                         "match verifier data")


def common_data_for_recursion(config, headroom_num: int = 3,
                              headroom_den: int = 2):
    """CommonCircuitData for cyclic recursion: the fixed point of "a
    circuit that verifies a proof of its own shape" (reference
    cyclic_recursion.rs:197-230), in three builds, the last padded to the
    power of two above headroom_num / headroom_den of its gates, room for
    the conditional verification and the application.  Each build stops
    at its common data (CircuitBuilder.build_common): nothing of them is
    committed or proved."""
    from ..gates.basic import NoopGate
    from .circuit_builder import CircuitBuilder

    common = CircuitBuilder(config).build_common()
    for final in (False, True):
        builder = CircuitBuilder(config)
        pt = builder.add_virtual_proof_with_pis(common)
        vt = builder.add_virtual_verifier_data(config.fri_config.cap_height)
        builder.verify_proof(pt, vt, common)
        if final:
            # build() pads a cyclic circuit to this degree, so too much
            # headroom costs proving time, not correctness
            target = 1 << log2_ceil(
                (builder.num_gates() * headroom_num) // headroom_den)
            while builder.num_gates() < target:
                builder.add_gate(NoopGate(), [])
        common = builder.build_common()
    return common


# -- builder mixin ------------------------------------------------------------

class ConditionalRecursionGadgets:
    """Mixed into CircuitBuilder."""

    # select helpers

    def select_vec(self, b, v0, v1) -> list:
        return [self.select(b, t0, t1) for t0, t1 in zip(v0, v1)]

    def select_hash(self, b, h0: HashOutTarget, h1: HashOutTarget):
        return tuple(self.select(b, a, c) for a, c in zip(h0, h1))

    def select_cap(self, b, cap0, cap1) -> list:
        if len(cap0) != len(cap1):
            raise ValueError("caps of different heights")
        return [self.select_hash(b, h0, h1) for h0, h1 in zip(cap0, cap1)]

    def select_vec_ext(self, b, v0, v1) -> list:
        return [self.select_ext(b, e0, e1) for e0, e1 in zip(v0, v1)]

    def _select_opening_set(self, b, os0: OpeningSetTarget,
                            os1: OpeningSetTarget) -> OpeningSetTarget:
        s = lambda a, c: self.select_vec_ext(b, a, c)  # noqa: E731
        return OpeningSetTarget(
            constants=s(os0.constants, os1.constants),
            plonk_sigmas=s(os0.plonk_sigmas, os1.plonk_sigmas),
            wires=s(os0.wires, os1.wires),
            plonk_zs=s(os0.plonk_zs, os1.plonk_zs),
            plonk_zs_next=s(os0.plonk_zs_next, os1.plonk_zs_next),
            partial_products=s(os0.partial_products, os1.partial_products),
            quotient_polys=s(os0.quotient_polys, os1.quotient_polys))

    def _select_opening_proof(self, b, p0: FriProofTarget,
                              p1: FriProofTarget) -> FriProofTarget:
        from ..fri.recursive_verifier import (FriInitialTreeProofTarget,
                                              FriQueryRoundTarget,
                                              FriQueryStepTarget)
        from ..gadgets.merkle import MerkleProofTarget
        from ..gadgets.polynomial import PolynomialCoeffsExtTarget

        def select_merkle_proof(m0, m1):
            return MerkleProofTarget(siblings=[
                self.select_hash(b, s0, s1)
                for s0, s1 in zip(m0.siblings, m1.siblings)])

        query_rounds = []
        for q0, q1 in zip(p0.query_round_proofs, p1.query_round_proofs):
            evals_proofs = [
                (self.select_vec(b, l0, l1), select_merkle_proof(m0, m1))
                for (l0, m0), (l1, m1) in zip(
                    q0.initial_trees_proof.evals_proofs,
                    q1.initial_trees_proof.evals_proofs)]
            steps = [
                FriQueryStepTarget(
                    evals=self.select_vec_ext(b, s0.evals, s1.evals),
                    merkle_proof=select_merkle_proof(s0.merkle_proof,
                                                     s1.merkle_proof))
                for s0, s1 in zip(q0.steps, q1.steps)]
            query_rounds.append(FriQueryRoundTarget(
                initial_trees_proof=FriInitialTreeProofTarget(evals_proofs),
                steps=steps))

        return FriProofTarget(
            commit_phase_merkle_caps=[
                self.select_cap(b, c0, c1)
                for c0, c1 in zip(p0.commit_phase_merkle_caps,
                                  p1.commit_phase_merkle_caps)],
            query_round_proofs=query_rounds,
            final_poly=PolynomialCoeffsExtTarget(
                self.select_vec_ext(b, p0.final_poly.coeffs,
                                    p1.final_poly.coeffs)),
            pow_witness=self.select(b, p0.pow_witness, p1.pow_witness))

    def select_proof_with_pis(self, b, pwp0: ProofWithPublicInputsTarget,
                              pwp1: ProofWithPublicInputsTarget
                              ) -> ProofWithPublicInputsTarget:
        return ProofWithPublicInputsTarget(
            proof=ProofTarget(
                wires_cap=self.select_cap(b, pwp0.proof.wires_cap,
                                          pwp1.proof.wires_cap),
                plonk_zs_partial_products_cap=self.select_cap(
                    b, pwp0.proof.plonk_zs_partial_products_cap,
                    pwp1.proof.plonk_zs_partial_products_cap),
                quotient_polys_cap=self.select_cap(
                    b, pwp0.proof.quotient_polys_cap,
                    pwp1.proof.quotient_polys_cap),
                openings=self._select_opening_set(b, pwp0.proof.openings,
                                                  pwp1.proof.openings),
                opening_proof=self._select_opening_proof(
                    b, pwp0.proof.opening_proof, pwp1.proof.opening_proof)),
            public_inputs=self.select_vec(b, pwp0.public_inputs,
                                          pwp1.public_inputs))

    # conditional verification

    def conditionally_verify_proof(self, condition, pwp0, vd0, pwp1, vd1,
                                   inner_common_data) -> None:
        """Verify pwp0 if condition else pwp1 (same CommonCircuitData)."""
        selected = self.select_proof_with_pis(condition, pwp0, pwp1)
        selected_vd = VerifierCircuitTarget(
            constants_sigmas_cap=self.select_cap(
                condition, vd0.constants_sigmas_cap, vd1.constants_sigmas_cap),
            circuit_digest=self.select_hash(condition, vd0.circuit_digest,
                                            vd1.circuit_digest))
        self.verify_proof(selected, selected_vd, inner_common_data)

    def dummy_proof_and_vk(self, common_data, device=None, rng=None,
                           circuit=None):
        """Targets of a dummy proof of `common_data`'s shape and its
        verifier data, which a generator sets; the dummy proof is made
        now, on `device`, of `circuit` (the dummy circuit of
        `common_data`, built here unless given)."""
        if circuit is None:
            circuit = dummy_circuit(common_data, device)
        proof = dummy_proof(circuit, {}, device, rng)
        pt = self.add_virtual_proof_with_pis(common_data)
        vt = self.add_virtual_verifier_data(self.config.fri_config.cap_height)
        self.generators.append(
            DummyProofGenerator(pt, proof, vt, circuit.verifier_only))
        return pt, vt

    def conditionally_verify_proof_or_dummy(self, condition, pwp, vd,
                                            inner_common_data, device=None,
                                            rng=None) -> None:
        dummy_pt, dummy_vt = self.dummy_proof_and_vk(inner_common_data,
                                                     device, rng)
        self.conditionally_verify_proof(condition, pwp, vd, dummy_pt,
                                        dummy_vt, inner_common_data)

    # cyclic recursion (reference cyclic_recursion.rs:68-156)

    def add_verifier_data_public_inputs(self) -> VerifierCircuitTarget:
        if self.verifier_data_public_input is not None:
            raise ValueError("add_verifier_data_public_inputs only needs to "
                             "be called once")
        vd = self.add_virtual_verifier_data(self.config.fri_config.cap_height)
        self.register_public_inputs(vd.circuit_digest)
        for h in vd.constants_sigmas_cap:
            self.register_public_inputs(h)
        self.verifier_data_public_input = vd
        return vd

    def conditionally_verify_cyclic_proof(
            self, condition, cyclic_pwp: ProofWithPublicInputsTarget,
            other_pwp, other_vd, common_data) -> None:
        vd = self.verifier_data_public_input
        if vd is None:
            raise ValueError("Must call add_verifier_data_public_inputs "
                             "before cyclic recursion")
        if self.goal_common_data is not None:
            if self.goal_common_data != common_data:
                raise ValueError("another cyclic goal than this builder's")
        else:
            self.goal_common_data = common_data

        digest, cap = verifier_data_from_pis(cyclic_pwp.public_inputs,
                                             common_data)
        # every proof in the cycle must use the same verifier data
        self.connect_hashes(digest, vd.circuit_digest)
        self.connect_merkle_caps(cap, vd.constants_sigmas_cap)

        self.conditionally_verify_proof(condition, cyclic_pwp, vd, other_pwp,
                                        other_vd, common_data)

        for g in common_data.gates:
            self.add_gate_to_gate_set(g)

    def conditionally_verify_cyclic_proof_or_dummy(self, condition, cyclic_pwp,
                                                   common_data, device=None,
                                                   rng=None,
                                                   dummy=None) -> None:
        """Verify `cyclic_pwp` if `condition`, else a dummy proof, which
        is proved now on `device` (of `dummy`, the dummy circuit, where
        given)."""
        dummy_pt, dummy_vt = self.dummy_proof_and_vk(common_data, device,
                                                     rng, dummy)
        self.conditionally_verify_cyclic_proof(condition, cyclic_pwp, dummy_pt,
                                               dummy_vt, common_data)
