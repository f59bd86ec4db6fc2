"""The FRI verifier (the port's copy of plonky2_tpu/fri/verifier.py;
reference plonky2/src/fri/verifier.rs).

Host logic on python ints: the query rounds' Merkle paths (hash/merkle.py,
with the circuit's hasher),
the initial combination, the folds by barycentric interpolation and the
final polynomial.  It shares no code with the prover's device path, so it
checks the kernels independently.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..field import extension as ge
from ..field import goldilocks as gl
from ..hash.hashers import POSEIDON_CONFIG
from ..hash.merkle import verify_merkle_proof_to_cap
from ..utils.bits import log2_strict, reverse_bits
from .config import FriConfig, FriParams
from .proof import FriChallenges, FriInitialTreeProof, FriProof
from .structure import FriInstanceInfo, FriOpenings


class FriVerificationError(Exception):
    pass


def _ensure(cond: bool, msg: str) -> None:
    if not cond:
        raise FriVerificationError(msg)


Ext = Tuple[int, int]


def _ext(x) -> Ext:
    a = np.asarray(x).reshape(-1)
    return (int(a[0]), int(a[1]))


class ReducingFactor:
    """Horner folding by powers of alpha, counting the powers used
    (reference util/reducing.rs)."""

    def __init__(self, base: Ext):
        self.base = base
        self.count = 0

    def reduce(self, values) -> Ext:
        acc = (0, 0)
        for v in reversed(list(values)):
            acc = ge.s_mul(acc, self.base)
            self.count += 1
            acc = ge.s_add(acc, v if isinstance(v, tuple) else _ext(v))
        return acc

    def shift(self, x: Ext) -> Ext:
        out = ge.s_mul(ge.s_exp(self.base, self.count), x)
        self.count = 0
        return out


def compute_evaluation(x: int, x_index_within_coset: int, arity_bits: int,
                       evals: np.ndarray, beta: Ext) -> Ext:
    """P'(x^arity) from the P(x g^i) of one coset: the interpolant at beta
    (reference verifier.rs:21-46)."""
    arity = 1 << arity_bits
    if evals.shape[0] != arity:
        raise FriVerificationError(f"a fold step has {evals.shape[0]} "
                                   f"values, expected {arity}")
    g = gl.primitive_root_of_unity(arity_bits)

    evals_ord = [_ext(evals[reverse_bits(i, arity_bits)])
                 for i in range(arity)]
    rev_x = reverse_bits(x_index_within_coset, arity_bits)
    coset_start = (x * pow(g, arity - rev_x, gl.P)) % gl.P
    xs = []
    y = coset_start
    for _ in range(arity):
        xs.append(y)
        y = (y * g) % gl.P

    # barycentric weights over the base-field points
    weights = []
    for i in range(arity):
        w = 1
        for j in range(arity):
            if j != i:
                w = (w * (xs[i] - xs[j])) % gl.P
        weights.append(pow(w, gl.P - 2, gl.P))

    # beta on a node (only if beta lies in the base field)
    for i in range(arity):
        if beta == (xs[i] % gl.P, 0):
            return evals_ord[i]

    l_x: Ext = (1, 0)
    for xi in xs:
        l_x = ge.s_mul(l_x, ge.s_sub(beta, (xi, 0)))
    total: Ext = (0, 0)
    for i in range(arity):
        term = ge.s_mul(ge.s_inv(ge.s_sub(beta, (xs[i], 0))), (weights[i], 0))
        total = ge.s_add(total, ge.s_mul(term, evals_ord[i]))
    return ge.s_mul(l_x, total)


def fri_verify_proof_of_work(fri_pow_response: int,
                             config: FriConfig) -> None:
    _ensure(fri_pow_response < (1 << (64 - config.proof_of_work_bits)),
            "Invalid proof of work witness.")


class PrecomputedReducedOpenings:
    def __init__(self, openings: FriOpenings, alpha: Ext):
        self.reduced_openings_at_point = [
            ReducingFactor(alpha).reduce(batch.values)
            for batch in openings.batches]


def fri_combine_initial(instance: FriInstanceInfo, proof: FriInitialTreeProof,
                        alpha_ext: Ext, subgroup_x: int,
                        precomputed: PrecomputedReducedOpenings,
                        params: FriParams) -> Ext:
    alpha = ReducingFactor(alpha_ext)
    total: Ext = (0, 0)
    sx: Ext = (subgroup_x, 0)
    for batch, reduced_openings in zip(instance.batches,
                                       precomputed.reduced_openings_at_point):
        evals = []
        for p in batch.polynomials:
            salted = params.hiding and instance.oracles[p.oracle_index].blinding
            evals.append((proof.unsalted_eval(p.oracle_index,
                                              p.polynomial_index, salted), 0))
        numerator = ge.s_sub(alpha.reduce(evals), reduced_openings)
        denominator = ge.s_sub(sx, _ext(np.asarray(batch.point,
                                                   dtype=np.uint64)))
        total = alpha.shift(total)
        total = ge.s_add(total, ge.s_mul(numerator, ge.s_inv(denominator)))
    return ge.s_mul(total, sx)


def _eval_final_poly(coeffs: np.ndarray, x: Ext) -> Ext:
    acc: Ext = (0, 0)
    for i in range(coeffs.shape[0] - 1, -1, -1):
        acc = ge.s_add(ge.s_mul(acc, x), _ext(coeffs[i]))
    return acc


def fri_verifier_query_round(instance: FriInstanceInfo,
                             challenges: FriChallenges,
                             precomputed: PrecomputedReducedOpenings,
                             initial_merkle_caps, proof: FriProof,
                             x_index: int, n: int, round_proof,
                             params: FriParams,
                             hasher=POSEIDON_CONFIG) -> None:
    for (evals, merkle_proof), cap in zip(
            round_proof.initial_trees_proof.evals_proofs, initial_merkle_caps):
        _ensure(verify_merkle_proof_to_cap(evals, x_index, cap, merkle_proof,
                                           hasher),
                "initial Merkle proof invalid")

    log_n = log2_strict(n)
    subgroup_x = (gl.MULTIPLICATIVE_GROUP_GENERATOR
                  * pow(gl.primitive_root_of_unity(log_n),
                        reverse_bits(x_index, log_n), gl.P)) % gl.P

    old_eval = fri_combine_initial(instance, round_proof.initial_trees_proof,
                                   challenges.fri_alpha, subgroup_x,
                                   precomputed, params)

    for i, arity_bits in enumerate(params.reduction_arity_bits):
        arity = 1 << arity_bits
        evals = np.asarray(round_proof.steps[i].evals)
        coset_index = x_index >> arity_bits
        x_index_within_coset = x_index & (arity - 1)
        _ensure(_ext(evals[x_index_within_coset]) == old_eval,
                f"consistency check failed at round {i}")
        old_eval = compute_evaluation(subgroup_x, x_index_within_coset,
                                      arity_bits, evals,
                                      challenges.fri_betas[i])
        _ensure(verify_merkle_proof_to_cap(
            evals.reshape(-1), coset_index, proof.commit_phase_merkle_caps[i],
            round_proof.steps[i].merkle_proof, hasher),
            f"commit-phase proof {i} invalid")
        subgroup_x = pow(subgroup_x, arity, gl.P)
        x_index = coset_index

    _ensure(_eval_final_poly(np.asarray(proof.final_poly),
                             (subgroup_x, 0)) == old_eval,
            "Final polynomial evaluation is invalid.")


def verify_fri_proof(instance: FriInstanceInfo, openings: FriOpenings,
                     challenges: FriChallenges, initial_merkle_caps,
                     proof: FriProof, params: FriParams,
                     hasher=POSEIDON_CONFIG) -> None:
    n = params.lde_size()
    fri_verify_proof_of_work(challenges.fri_pow_response, params.config)
    _ensure(params.config.num_query_rounds == len(proof.query_round_proofs),
            "Number of query rounds does not match config.")
    precomputed = PrecomputedReducedOpenings(openings, challenges.fri_alpha)
    for x_index, round_proof in zip(challenges.fri_query_indices,
                                    proof.query_round_proofs):
        fri_verifier_query_round(instance, challenges, precomputed,
                                 initial_merkle_caps, proof, x_index, n,
                                 round_proof, params, hasher)
