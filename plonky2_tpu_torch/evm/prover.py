"""The multi-table STARK prover with cross-table lookups: the port's
counterpart of plonky2_tpu/evm/prover.py (reference evm/src/prover.rs),
with the same transcript and proof.

All tables share one Fiat-Shamir challenger: every trace cap is observed
first, the CTL challenges are drawn once, then each table runs its
single-table protocol in turn, the transcript compacted before each.  On
the device: the commitments (fri/oracle.py: K3/K5, K1, K2), the
permutation and CTL Z polynomials (torch ops), the quotient (the table's
compiled constraint program on K6, stark/quotient_program.py, then a coset
INTT), the openings (ops/openings.py, the CTL Zs at g^-1 among them) and
the FRI proof (fri/device_prover.py: the fused FRI with K9, the grind
with K8)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from .. import resolve_device
from ..field import extension as ext
from ..field import goldilocks as gl
from ..fri.challenges import observe_openings
from ..fri.device_prover import device_prove_openings
from ..fri.oracle import PolynomialBatch, _on_device
from ..fri.structure import (FriBatchInfo, FriInstanceInfo, FriOracleInfo,
                             FriPolynomialInfo)
from ..iop.challenger import Challenger
from ..ops.openings import (eval_device_polys_ext, eval_openings_batched,
                            ext_powers)
from ..stark.permutation import (compute_permutation_z_polys,
                                 get_n_permutation_challenge_sets)
from ..stark.quotient_program import (num_permutation_zs, quotient_context,
                                      quotient_scalars, stark_program)
from ..stark.stark import Stark
from ..utils.bits import log2_strict
from ..utils.timing import NoopTiming, Prefixed
from .cross_table_lookup import (CrossTableLookup, CtlData,
                                 cross_table_lookup_data, ctl_zs_layout)
from .proof import AllProof, EvmStarkOpeningSet, EvmStarkProof


@dataclass
class AllStark:
    starks: List[Stark]
    cross_table_lookups: List[CrossTableLookup]

    def num_tables(self) -> int:
        return len(self.starks)

    def programs(self, config) -> list:
        """Each table's quotient program (compiled on first use, then
        kept on the table's Stark object)."""
        nch = config.num_challenges
        return [stark_program(s, config,
                              ctl_zs_layout(self.cross_table_lookups, i, nch))
                for i, s in enumerate(self.starks)]


def evm_fri_instance(stark: Stark, zeta, g: int, g_inv: int,
                     num_perm_zs: int, num_ctl_zs: int,
                     config) -> FriInstanceInfo:
    """(reference evm/src/stark.rs:83-143)."""
    num_perm_ctl = num_perm_zs + num_ctl_zs
    oracles = [FriOracleInfo(stark.COLUMNS, False),
               FriOracleInfo(num_perm_ctl, False)]
    trace_info = FriPolynomialInfo.from_range(0, range(stark.COLUMNS))
    perm_ctl_info = FriPolynomialInfo.from_range(1, range(num_perm_ctl))
    ctl_zs_info = FriPolynomialInfo.from_range(
        1, range(num_perm_zs, num_perm_ctl))
    nq = stark.quotient_degree_factor() * config.num_challenges
    quotient_info = FriPolynomialInfo.from_range(2, range(nq))
    oracles.append(FriOracleInfo(nq, False))
    zeta_next = ext.s_mul(zeta, (g, 0))
    return FriInstanceInfo(
        oracles=oracles,
        batches=[
            FriBatchInfo(zeta, trace_info + perm_ctl_info + quotient_info),
            FriBatchInfo(zeta_next, trace_info + perm_ctl_info),
            FriBatchInfo((g_inv, 0), ctl_zs_info),
        ])


def prove_all(all_stark: AllStark, config, traces, device=None,
              timing=None) -> AllProof:
    """traces: each table's (COLUMNS, degree) values (numpy uint64 or
    int64 tensors).  Runs on `device` (default cuda)."""
    timing = timing if timing is not None else NoopTiming()
    dev = resolve_device(device)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    programs = all_stark.programs(config)
    traces = [_on_device(t, dev) for t in traces]
    with timing.scope("trace commitments"):
        commitments = [PolynomialBatch.from_values(t, rate_bits, False,
                                                   cap_height, device=dev)
                       for t in traces]
    challenger = Challenger()
    for c in commitments:
        challenger.observe_cap(c.merkle_tree.cap)
    with timing.scope("CTL Z polynomials"):
        ctl_data_per_table, ctl_challenges = cross_table_lookup_data(
            config, traces, all_stark.cross_table_lookups, challenger)
    proofs = []
    for stark, trace, commitment, ctl_data, program in zip(
            all_stark.starks, traces, commitments, ctl_data_per_table,
            programs):
        proofs.append(prove_single_table(
            stark, config, trace, commitment, ctl_data, ctl_challenges,
            challenger, program,
            Prefixed(timing, f"{type(stark).__name__}: ")))
    return AllProof(stark_proofs=proofs,
                    degree_bits=[log2_strict(t.shape[1]) for t in traces])


def prove_single_table(stark: Stark, config, trace: torch.Tensor,
                       trace_commitment: PolynomialBatch, ctl_data: CtlData,
                       ctl_challenges, challenger: Challenger, program,
                       timing=None) -> EvmStarkProof:
    """(reference evm/src/prover.rs:245-430); ``program`` is the table's
    quotient program (AllStark.programs)."""
    timing = timing if timing is not None else NoopTiming()
    degree = trace.shape[1]
    degree_bits = log2_strict(degree)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    fri_params = config.fri_params(degree_bits)
    dev = trace.device

    challenger.compact()
    challenge_sets = None
    with timing.scope("Z polynomials"):
        zs = []
        if stark.uses_permutation_args():
            challenge_sets = get_n_permutation_challenge_sets(
                challenger, config.num_challenges,
                stark.permutation_batch_size())
            zs.append(compute_permutation_z_polys(stark, config, trace,
                                                  challenge_sets))
        num_perm_zs = num_permutation_zs(stark, config)
        num_ctl_zs = len(ctl_data.zs_columns)
        if ctl_data.zs_columns:
            zs.append(torch.stack(ctl_data.z_polys()))
        if not zs:
            raise ValueError("the table has neither permutation nor CTL "
                             "polynomials")
        perm_ctl_commitment = PolynomialBatch.from_values(
            torch.cat(zs), rate_bits, False, cap_height, device=dev)
    challenger.observe_cap(perm_ctl_commitment.merkle_tree.cap)
    alphas = challenger.get_n_challenges(config.num_challenges)

    with timing.scope("quotient"):
        chunks = quotient_context(
            stark, program, degree_bits, rate_bits, str(dev)).compute(
            trace_commitment, perm_ctl_commitment,
            quotient_scalars(alphas, challenge_sets,
                             ctl_challenges.challenges if num_ctl_zs
                             else None))
        quotient_commitment = PolynomialBatch.from_coeffs(
            chunks, rate_bits, False, cap_height, device=dev)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    zeta = challenger.get_extension_challenge()
    if ext.s_exp(zeta, degree) == ext.ONE:
        raise RuntimeError("the opening point is in the subgroup")
    g = gl.primitive_root_of_unity(degree_bits)
    g_inv = gl.s_inv(g)
    zeta_next = ext.s_mul(zeta, (g, 0))
    with timing.scope("openings"):
        (local, nxt), (zs_local, zs_next) = eval_openings_batched(
            [trace_commitment, perm_ctl_commitment], [zeta, zeta_next])
        (quotient,), = eval_openings_batched([quotient_commitment], [zeta])
        ctl_coeffs = perm_ctl_commitment.coeffs_dev[num_perm_zs:]
        ctl_zs_last = eval_device_polys_ext(
            ctl_coeffs, ext_powers((g_inv, 0), degree, dev))[:, 0]
        openings = EvmStarkOpeningSet(
            local_values=local, next_values=nxt,
            permutation_ctl_zs=zs_local, permutation_ctl_zs_next=zs_next,
            ctl_zs_last=[int(v) for v in ctl_zs_last],
            quotient_polys=quotient)
        fri_openings = openings.to_fri_openings()
        observe_openings(challenger, fri_openings)
    instance = evm_fri_instance(stark, zeta, g, g_inv, num_perm_zs,
                                num_ctl_zs, config)
    opening_proof = device_prove_openings(
        instance, [trace_commitment, perm_ctl_commitment,
                   quotient_commitment], fri_openings, challenger,
        fri_params, timing)
    return EvmStarkProof(
        trace_cap=trace_commitment.merkle_tree.cap,
        permutation_ctl_zs_cap=perm_ctl_commitment.merkle_tree.cap,
        quotient_polys_cap=quotient_commitment.merkle_tree.cap,
        openings=openings, opening_proof=opening_proof)
