"""The multi-table verifier: each table's STARK checks with its CTL
constraints, then the cross-table grand products.  The port's counterpart
of plonky2_tpu/evm/verifier.py (reference evm/src/verifier.rs,
evm/src/get_challenges.rs), on the host."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..field import extension as ext
from ..field import goldilocks as gl
from ..fri.challenges import fri_challenges, observe_openings
from ..fri.verifier import verify_fri_proof
from ..iop.challenger import Challenger
from ..plonk.algebra import ScalarExt
from ..stark.permutation import (challenge_values, eval_permutation_checks,
                                 get_n_permutation_challenge_sets)
from ..stark.quotient_program import num_permutation_zs
from ..stark.stark import ConstraintConsumer, StarkEvaluationVars
from ..stark.verifier import check_quotient, eval_l_0_and_l_last
from .cross_table_lookup import (CtlCheckVars, GrandProductChallenge,
                                 ctl_check_vars_per_table,
                                 eval_cross_table_lookup_checks,
                                 get_grand_product_challenge_set,
                                 verify_cross_table_lookups)
from .proof import AllProof
from .prover import AllStark, evm_fri_instance


@dataclass
class SingleTableChallenges:
    permutation_challenge_sets: object
    stark_alphas: List[int]
    stark_zeta: tuple
    fri_challenges: object


class EvmVerificationError(Exception):
    pass


def _ensure(cond, msg):
    if not cond:
        raise EvmVerificationError(msg)


def get_all_challenges(all_stark: AllStark, all_proof: AllProof, config):
    ch = Challenger()
    for p in all_proof.stark_proofs:
        ch.observe_cap(p.trace_cap)
    ctl_challenges = get_grand_product_challenge_set(ch,
                                                     config.num_challenges)
    per_table = []
    for stark, proof, db in zip(all_stark.starks, all_proof.stark_proofs,
                                all_proof.degree_bits):
        ch.compact()
        challenge_sets = None
        if stark.uses_permutation_args():
            challenge_sets = get_n_permutation_challenge_sets(
                ch, config.num_challenges, stark.permutation_batch_size())
        ch.observe_cap(proof.permutation_ctl_zs_cap)
        alphas = ch.get_n_challenges(config.num_challenges)
        ch.observe_cap(proof.quotient_polys_cap)
        zeta = ch.get_extension_challenge()
        observe_openings(ch, proof.openings.to_fri_openings())
        per_table.append(SingleTableChallenges(
            permutation_challenge_sets=challenge_sets,
            stark_alphas=alphas, stark_zeta=zeta,
            fri_challenges=fri_challenges(
                ch, proof.opening_proof.commit_phase_merkle_caps,
                proof.opening_proof.final_poly,
                proof.opening_proof.pow_witness, db, config.fri_config)))
    return ctl_challenges, per_table


def verify_all_proof(all_stark: AllStark, all_proof: AllProof,
                     config) -> None:
    _ensure(len(all_proof.stark_proofs) == all_stark.num_tables(),
            "wrong number of table proofs")
    ctl_challenges, per_table = get_all_challenges(all_stark, all_proof,
                                                   config)
    nums_permutation_zs = [num_permutation_zs(s, config)
                           for s in all_stark.starks]
    ctl_vars_per_table = ctl_check_vars_per_table(
        all_proof.stark_proofs, all_stark.cross_table_lookups,
        ctl_challenges, nums_permutation_zs)
    for stark, proof, challenges, ctl_vars, num_perm, db in zip(
            all_stark.starks, all_proof.stark_proofs, per_table,
            ctl_vars_per_table, nums_permutation_zs, all_proof.degree_bits):
        _verify_single_table(stark, proof, challenges, ctl_vars, num_perm,
                             db, config)
    verify_cross_table_lookups(
        all_stark.cross_table_lookups,
        [p.openings.ctl_zs_last for p in all_proof.stark_proofs],
        ctl_challenges, config)


def _to_ext(arr) -> list:
    return [(int(v[0]), int(v[1])) for v in arr]


def _verify_single_table(stark, proof, challenges, ctl_vars, num_perm_zs,
                         degree_bits, config) -> None:
    alg = ScalarExt()
    vars = StarkEvaluationVars(
        local_values=_to_ext(proof.openings.local_values),
        next_values=_to_ext(proof.openings.next_values),
        public_inputs=[])
    zeta = challenges.stark_zeta
    g = gl.primitive_root_of_unity(degree_bits)
    l_0, l_last = eval_l_0_and_l_last(degree_bits, zeta)
    z_last = ext.s_sub(zeta, (gl.s_inv(g), 0))
    consumer = ConstraintConsumer(
        alg, [alg.const(a) for a in challenges.stark_alphas], z_last, l_0,
        l_last)
    stark.eval(alg, vars, consumer)
    perm_ctl_zs = _to_ext(proof.openings.permutation_ctl_zs)
    perm_ctl_zs_next = _to_ext(proof.openings.permutation_ctl_zs_next)
    if stark.uses_permutation_args():
        eval_permutation_checks(
            alg, stark, config, vars, perm_ctl_zs[:num_perm_zs],
            perm_ctl_zs_next[:num_perm_zs],
            challenge_values(alg, challenges.permutation_challenge_sets),
            consumer)
    eval_cross_table_lookup_checks(alg, vars, [
        CtlCheckVars(v.local_z, v.next_z,
                     GrandProductChallenge(alg.const(v.challenge.beta),
                                           alg.const(v.challenge.gamma)),
                     v.columns, v.filter_column) for v in ctl_vars],
        consumer)
    check_quotient(consumer.accumulators(),
                   _to_ext(proof.openings.quotient_polys), zeta, degree_bits,
                   stark.quotient_degree_factor(), config.num_challenges,
                   lambda msg: _ensure(False, msg))
    num_ctl_zs = len(proof.openings.ctl_zs_last)
    instance = evm_fri_instance(stark, zeta, g, gl.s_inv(g), num_perm_zs,
                                num_ctl_zs, config)
    verify_fri_proof(instance, proof.openings.to_fri_openings(),
                     challenges.fri_challenges,
                     [proof.trace_cap, proof.permutation_ctl_zs_cap,
                      proof.quotient_polys_cap],
                     proof.opening_proof, config.fri_params(degree_bits))
