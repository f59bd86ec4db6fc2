"""Proof compression (the port's copy of plonky2_tpu/plonk/compression.py;
reference plonky2/src/fri/proof.rs:90-385, plonk/proof.rs:54-280,
plonk/get_challenges.rs:160-235).

Three redundancies go: the query rounds of repeated indices, the one value
of each fold step that the verifier infers from the previous fold, and the
Merkle path nodes that query paths share (hash/path_compression.py).
Host Python, as the verifier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..field import goldilocks as gl
from ..fri.proof import (FriInitialTreeProof, FriProof, FriQueryRound,
                         FriQueryStep)
from ..fri.verifier import (PrecomputedReducedOpenings, compute_evaluation,
                            fri_combine_initial)
from ..hash import poseidon as pos
from ..hash.merkle import MerkleCap
from ..hash.path_compression import (compress_merkle_proofs,
                                     decompress_merkle_proofs)
from ..utils.bits import reverse_bits
from .get_challenges import get_challenges
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .verifier import ProofVerificationError, verify_with_challenges


@dataclass
class CompressedFriQueryRounds:
    indices: List[int]
    initial_trees_proofs: Dict[int, FriInitialTreeProof]
    steps: List[Dict[int, FriQueryStep]]


@dataclass
class CompressedFriProof:
    commit_phase_merkle_caps: List[MerkleCap]
    query_round_proofs: CompressedFriQueryRounds
    final_poly: np.ndarray
    pow_witness: int


@dataclass
class CompressedProof:
    wires_cap: MerkleCap
    plonk_zs_partial_products_cap: MerkleCap
    quotient_polys_cap: MerkleCap
    openings: OpeningSet
    opening_proof: CompressedFriProof


@dataclass
class CompressedProofWithPublicInputs:
    proof: CompressedProof
    public_inputs: List[int]

    def get_public_inputs_hash(self):
        return pos.hash_no_pad(np.array(self.public_inputs, dtype=np.uint64))


def _compress_fri_proof(fri: FriProof, indices: List[int],
                        params) -> CompressedFriProof:
    """reference fri/proof.rs:138-242."""
    cap_height = params.config.cap_height
    arity_bits = params.reduction_arity_bits
    num_reductions = len(arity_bits)
    num_initial = len(
        fri.query_round_proofs[0].initial_trees_proof.evals_proofs)

    it_indices = [[] for _ in range(num_initial)]
    it_leaves = [[] for _ in range(num_initial)]
    it_proofs = [[] for _ in range(num_initial)]
    st_indices = [[] for _ in range(num_reductions)]
    st_evals = [[] for _ in range(num_reductions)]
    st_proofs = [[] for _ in range(num_reductions)]

    for index, qrp in zip(indices, fri.query_round_proofs):
        idx = index
        for i, (leaves, proof) in enumerate(
                qrp.initial_trees_proof.evals_proofs):
            it_indices[i].append(idx)
            it_leaves[i].append(leaves)
            it_proofs[i].append(proof)
        for i, step in enumerate(qrp.steps):
            within = idx & ((1 << arity_bits[i]) - 1)
            idx >>= arity_bits[i]
            st_indices[i].append(idx)
            evals = np.delete(step.evals, within, axis=0)  # inferable element
            st_evals[i].append(evals)
            st_proofs[i].append(step.merkle_proof)

    it_proofs = [compress_merkle_proofs(cap_height, iks, ps)
                 for iks, ps in zip(it_indices, it_proofs)]
    st_proofs = [compress_merkle_proofs(cap_height, iks, ps)
                 for iks, ps in zip(st_indices, st_proofs)]

    compressed = CompressedFriQueryRounds(
        indices=list(indices), initial_trees_proofs={},
        steps=[{} for _ in range(num_reductions)])
    for i, index in enumerate(indices):
        idx = index
        initial = FriInitialTreeProof(evals_proofs=[
            (it_leaves[j][i], it_proofs[j][i]) for j in range(num_initial)])
        compressed.initial_trees_proofs.setdefault(idx, initial)
        for j in range(num_reductions):
            idx >>= arity_bits[j]
            step = FriQueryStep(evals=st_evals[j][i],
                                merkle_proof=st_proofs[j][i])
            compressed.steps[j].setdefault(idx, step)

    return CompressedFriProof(
        commit_phase_merkle_caps=fri.commit_phase_merkle_caps,
        query_round_proofs=compressed, final_poly=fri.final_poly,
        pow_witness=fri.pow_witness)


def compress_proof(pwp: ProofWithPublicInputs, circuit_digest,
                   common_data) -> CompressedProofWithPublicInputs:
    challenges = get_challenges(pwp, pwp.get_public_inputs_hash(),
                                circuit_digest, common_data)
    indices = challenges.fri_challenges.fri_query_indices
    proof = pwp.proof
    return CompressedProofWithPublicInputs(
        proof=CompressedProof(
            wires_cap=proof.wires_cap,
            plonk_zs_partial_products_cap=proof.plonk_zs_partial_products_cap,
            quotient_polys_cap=proof.quotient_polys_cap,
            openings=proof.openings,
            opening_proof=_compress_fri_proof(proof.opening_proof, indices,
                                              common_data.fri_params)),
        public_inputs=list(pwp.public_inputs))


def _get_inferred_elements(cpwp: CompressedProofWithPublicInputs, challenges,
                           common_data) -> List[Tuple[int, int]]:
    """Replay the fold inference (reference get_challenges.rs:160-235)."""
    params = common_data.fri_params
    zeta = challenges.plonk_zeta
    alpha = challenges.fri_challenges.fri_alpha
    betas = challenges.fri_challenges.fri_betas
    inferred = []
    seen_by_depth = [set() for _ in params.reduction_arity_bits]
    openings = cpwp.proof.openings.to_fri_openings()
    precomputed = PrecomputedReducedOpenings(openings, alpha)
    log_n = common_data.degree_bits() + params.config.rate_bits
    qrp = cpwp.proof.opening_proof.query_round_proofs
    for x_index in challenges.fri_challenges.fri_query_indices:
        subgroup_x = (gl.MULTIPLICATIVE_GROUP_GENERATOR
                      * pow(gl.primitive_root_of_unity(log_n),
                            reverse_bits(x_index, log_n), gl.P)) % gl.P
        old_eval = fri_combine_initial(
            common_data.get_fri_instance(zeta),
            qrp.initial_trees_proofs[x_index], alpha, subgroup_x, precomputed,
            params)
        for i, ab in enumerate(params.reduction_arity_bits):
            coset_index = x_index >> ab
            if coset_index in seen_by_depth[i]:
                break
            seen_by_depth[i].add(coset_index)
            inferred.append(old_eval)
            arity = 1 << ab
            within = x_index & (arity - 1)
            evals = np.insert(qrp.steps[i][coset_index].evals, within,
                              np.array(old_eval, dtype=np.uint64), axis=0)
            old_eval = compute_evaluation(subgroup_x, within, ab, evals,
                                          betas[i])
            subgroup_x = pow(subgroup_x, arity, gl.P)
            x_index = coset_index
    return inferred


def _decompress_fri_proof(cfri: CompressedFriProof, challenges, inferred,
                          params, hasher) -> FriProof:
    """reference fri/proof.rs:248-365."""
    indices = challenges.fri_challenges.fri_query_indices
    cap_height = params.config.cap_height
    arity_bits = params.reduction_arity_bits
    num_reductions = len(arity_bits)
    qrp = cfri.query_round_proofs
    num_initial = len(
        next(iter(qrp.initial_trees_proofs.values())).evals_proofs)
    inferred_iter = iter(inferred)

    it_indices = [[] for _ in range(num_initial)]
    it_leaves = [[] for _ in range(num_initial)]
    it_proofs = [[] for _ in range(num_initial)]
    st_indices = [[] for _ in range(num_reductions)]
    st_evals = [[] for _ in range(num_reductions)]
    st_proofs = [[] for _ in range(num_reductions)]
    height = params.degree_bits + params.config.rate_bits
    heights = []
    acc = height
    for ab in arity_bits:
        acc -= ab
        heights.append(acc)

    evals_by_depth = [dict() for _ in range(num_reductions)]
    for index in indices:
        idx = index
        initial = qrp.initial_trees_proofs[idx]
        for i, (leaves, proof) in enumerate(initial.evals_proofs):
            it_indices[i].append(idx)
            it_leaves[i].append(leaves)
            it_proofs[i].append(proof)
        for i in range(num_reductions):
            within = idx & ((1 << arity_bits[i]) - 1)
            idx >>= arity_bits[i]
            step = qrp.steps[i][idx]
            st_indices[i].append(idx)
            if idx in evals_by_depth[i]:
                evals = evals_by_depth[i][idx]
            else:
                evals = np.insert(step.evals, within,
                                  np.array(next(inferred_iter),
                                           dtype=np.uint64), axis=0)
                evals_by_depth[i][idx] = evals
            st_evals[i].append(evals)
            st_proofs[i].append(step.merkle_proof)

    it_proofs = [decompress_merkle_proofs(ls, iks, ps, height, cap_height,
                                          hasher)
                 for ls, iks, ps in zip(it_leaves, it_indices, it_proofs)]
    st_proofs = [decompress_merkle_proofs([e.reshape(-1) for e in ls], iks,
                                          ps, h, cap_height, hasher)
                 for ls, iks, ps, h in zip(st_evals, st_indices, st_proofs,
                                           heights)]

    rounds = []
    for i in range(len(indices)):
        initial = FriInitialTreeProof(evals_proofs=[
            (it_leaves[j][i], it_proofs[j][i]) for j in range(num_initial)])
        steps = [FriQueryStep(evals=st_evals[j][i],
                              merkle_proof=st_proofs[j][i])
                 for j in range(num_reductions)]
        rounds.append(FriQueryRound(initial_trees_proof=initial, steps=steps))

    return FriProof(commit_phase_merkle_caps=cfri.commit_phase_merkle_caps,
                    query_round_proofs=rounds, final_poly=cfri.final_poly,
                    pow_witness=cfri.pow_witness)


def _decompress(cpwp: CompressedProofWithPublicInputs, public_inputs_hash,
                circuit_digest, common_data):
    """(the proof, its challenges): the FRI query rounds rebuilt at the
    indices the transcript draws; a compressed proof that holds no round
    at one of them is refused."""
    challenges = get_challenges(cpwp, public_inputs_hash, circuit_digest,
                                common_data)
    try:
        inferred = _get_inferred_elements(cpwp, challenges, common_data)
        fri = _decompress_fri_proof(cpwp.proof.opening_proof, challenges,
                                    inferred, common_data.fri_params,
                                    common_data.hasher())
    except KeyError as e:
        raise ProofVerificationError(
            f"the compressed proof has no query round at index {e}") from e
    p = cpwp.proof
    proof = Proof(
        wires_cap=p.wires_cap,
        plonk_zs_partial_products_cap=p.plonk_zs_partial_products_cap,
        quotient_polys_cap=p.quotient_polys_cap, openings=p.openings,
        opening_proof=fri)
    return proof, challenges


def decompress_proof(cpwp: CompressedProofWithPublicInputs, circuit_digest,
                     common_data) -> ProofWithPublicInputs:
    proof, _ = _decompress(cpwp, cpwp.get_public_inputs_hash(),
                           circuit_digest, common_data)
    return ProofWithPublicInputs(proof=proof,
                                 public_inputs=list(cpwp.public_inputs))


def verify_compressed_proof(cpwp: CompressedProofWithPublicInputs,
                            verifier_data, common_data) -> None:
    if len(cpwp.public_inputs) != common_data.num_public_inputs:
        raise ProofVerificationError("wrong number of public inputs")
    public_inputs_hash = cpwp.get_public_inputs_hash()
    proof, challenges = _decompress(cpwp, public_inputs_hash,
                                    verifier_data.circuit_digest, common_data)
    verify_with_challenges(proof, public_inputs_hash, challenges,
                           verifier_data, common_data)
