"""Recursive aggregation of the multi-table EVM proof (the port's copy of
plonky2_tpu/evm/recursive_verifier.py; reference
evm/src/recursive_verifier.rs).

Each table's STARK proof is verified in a plonky2 circuit of its own, whose
public inputs are the table's trace cap, the CTL challenges, the
transcript's sponge state before and after the table's part of it, and
the table's ``ctl_zs_last`` openings.  The aggregate check then holds on
the host: every table used the same CTL challenges, the sponge states
chain from table to table, and the cross-table grand products balance.
So the AllProof comes down to plonky2 proofs.  Each wrapper proves through
a ProverSession on the device it was built on (default cuda).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..field import goldilocks as gl
from ..fri.challenges import fri_challenges as native_fri_challenges
from ..fri.challenges import observe_openings
from ..fri.recursive_verifier import (FriBatchInfoTarget,
                                      FriInstanceInfoTarget,
                                      FriOpeningBatchTarget,
                                      FriOpeningsTarget, FriProofTarget)
from ..fri.structure import FriOracleInfo, FriPolynomialInfo
from ..gadgets.reducing import ReducingFactorTarget
from ..hash import poseidon as pos
from ..iop.challenger import Challenger, RecursiveChallenger
from ..iop.witness import PartialWitness
from ..plonk.algebra import CircuitExtAlgebra
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig
from ..runtime.session import ProverSession
from ..stark.permutation import get_n_permutation_challenge_sets
from ..stark.recursive_verifier import (PermutationChallengeTarget,
                                        PermutationChallengeSetTarget,
                                        _eval_l_0_and_l_last_circuit,
                                        _eval_permutation_checks_circuit)
from ..stark.stark import ConstraintConsumer, Stark, StarkEvaluationVars
from .cross_table_lookup import (CrossTableLookup, GrandProductChallenge,
                                 GrandProductChallengeSet, ctl_zs_layout,
                                 get_grand_product_challenge_set,
                                 verify_cross_table_lookups)
from .prover import AllStark
from .proof import AllProof
from .verifier import _ensure


@dataclass
class GrandProductChallengeTarget:
    beta: object   # Target
    gamma: object  # Target


@dataclass
class EvmStarkOpeningSetTarget:
    local_values: list
    next_values: list
    permutation_ctl_zs: list
    permutation_ctl_zs_next: list
    ctl_zs_last: list        # base-field Targets
    quotient_polys: list

    def to_fri_openings(self, builder) -> FriOpeningsTarget:
        zeta = (list(self.local_values) + list(self.permutation_ctl_zs)
                + list(self.quotient_polys))
        zeta_next = (list(self.next_values)
                     + list(self.permutation_ctl_zs_next))
        last = [builder.convert_to_ext(t) for t in self.ctl_zs_last]
        return FriOpeningsTarget(batches=[FriOpeningBatchTarget(zeta),
                                          FriOpeningBatchTarget(zeta_next),
                                          FriOpeningBatchTarget(last)])


@dataclass
class EvmStarkProofTarget:
    trace_cap: list
    permutation_ctl_zs_cap: list
    quotient_polys_cap: list
    openings: EvmStarkOpeningSetTarget
    opening_proof: FriProofTarget


def add_virtual_evm_stark_proof(builder, stark: Stark, config,
                                degree_bits: int, num_perm_zs: int,
                                num_ctl_zs: int) -> EvmStarkProofTarget:
    """(reference recursive_verifier.rs:639-684)."""
    fri_params = config.fri_params(degree_bits)
    cap_height = fri_params.config.cap_height
    num_perm_ctl = num_perm_zs + num_ctl_zs
    nq = stark.quotient_degree_factor() * config.num_challenges
    num_leaves_per_oracle = [stark.COLUMNS, num_perm_ctl, nq]
    ext = builder.add_virtual_extension_targets
    openings = EvmStarkOpeningSetTarget(
        local_values=ext(stark.COLUMNS),
        next_values=ext(stark.COLUMNS),
        permutation_ctl_zs=ext(num_perm_ctl),
        permutation_ctl_zs_next=ext(num_perm_ctl),
        ctl_zs_last=builder.add_virtual_targets(num_ctl_zs),
        quotient_polys=ext(nq))
    return EvmStarkProofTarget(
        trace_cap=builder.add_virtual_cap(cap_height),
        permutation_ctl_zs_cap=builder.add_virtual_cap(cap_height),
        quotient_polys_cap=builder.add_virtual_cap(cap_height),
        openings=openings,
        opening_proof=builder.add_virtual_fri_proof(num_leaves_per_oracle,
                                                    fri_params))


def set_evm_stark_proof_target(pw: PartialWitness, pt: EvmStarkProofTarget,
                               proof) -> None:
    pw.set_cap_target(pt.trace_cap, proof.trace_cap)
    pw.set_cap_target(pt.permutation_ctl_zs_cap,
                      proof.permutation_ctl_zs_cap)
    pw.set_cap_target(pt.quotient_polys_cap, proof.quotient_polys_cap)
    ot, o = pt.openings, proof.openings
    pw.set_extension_targets(ot.local_values, o.local_values)
    pw.set_extension_targets(ot.next_values, o.next_values)
    pw.set_extension_targets(ot.permutation_ctl_zs, o.permutation_ctl_zs)
    pw.set_extension_targets(ot.permutation_ctl_zs_next,
                             o.permutation_ctl_zs_next)
    for t, v in zip(ot.ctl_zs_last, o.ctl_zs_last):
        pw.set_target(t, int(v))
    pw.set_extension_targets(ot.quotient_polys, o.quotient_polys)
    pw.set_fri_proof_target(pt.opening_proof, proof.opening_proof)


def _evm_fri_instance_target(builder, stark, zeta, g: int, num_perm_zs: int,
                             num_ctl_zs: int, config) -> FriInstanceInfoTarget:
    """Circuit mirror of prover.evm_fri_instance."""
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
    zeta_next = builder.mul_const_extension(g, zeta)
    g_inv = pow(g, gl.P - 2, gl.P)
    return FriInstanceInfoTarget(
        oracles=oracles,
        batches=[
            FriBatchInfoTarget(point=zeta,
                               polynomials=trace_info + perm_ctl_info
                               + quotient_info),
            FriBatchInfoTarget(point=zeta_next,
                               polynomials=trace_info + perm_ctl_info),
            FriBatchInfoTarget(point=builder.constant_extension((g_inv, 0)),
                               polynomials=ctl_zs_info),
        ])


def _eval_ctl_checks_circuit(builder, alg, vars, layout, zs, zs_next,
                             ctl_challenges: List[GrandProductChallengeTarget],
                             consumer) -> None:
    """The circuit form of eval_cross_table_lookup_checks: beta and gamma
    are targets here (reference cross_table_lookup.rs, its circuit form);
    `layout` is the table's ctl_zs_layout."""
    one = alg.one()
    for (columns, filter_column, c), z, z_next in zip(layout, zs, zs_next):
        ch = ctl_challenges[c]
        beta = builder.convert_to_ext(ch.beta)
        gamma = builder.convert_to_ext(ch.gamma)

        def combine(values):
            evals = [col.eval_alg(alg, values) for col in columns]
            acc = alg.zero()
            for e in reversed(evals):
                acc = alg.add(alg.mul(acc, beta), e)
            return alg.add(acc, gamma)

        def filt(values):
            if filter_column is not None:
                return filter_column.eval_alg(alg, values)
            return one

        def select(f, x):
            return alg.add(alg.mul(f, x), alg.sub(one, f))

        consumer.constraint_first_row(
            alg.sub(z, select(filt(vars.local_values),
                              combine(vars.local_values))))
        consumer.constraint_transition(
            alg.sub(z_next,
                    alg.mul(z, select(filt(vars.next_values),
                                      combine(vars.next_values)))))


@dataclass
class TableWrapperCircuit:
    """One table's wrapper circuit, its session and its input targets."""
    data: object                       # CircuitData
    session: ProverSession
    proof_target: EvmStarkProofTarget
    state_before: list                 # 12 Targets
    ctl_challenge_targets: list        # [(beta, gamma) Target pairs]


def recursive_stark_circuit(stark: Stark,
                            cross_table_lookups: List[CrossTableLookup],
                            table: int, degree_bits: int, inner_config,
                            circuit_config: Optional[CircuitConfig] = None,
                            device=None, timing=None) -> TableWrapperCircuit:
    """The circuit that verifies one table's STARK proof, built and given
    its session on `device` (default cuda; `timing` goes to the session)
    (reference recursive_verifier.rs:242-320, 385-492).

    Public inputs, in order: trace cap (4 per digest), CTL challenges
    (beta, gamma per challenge), challenger state before (12), challenger
    state after (12), ctl_zs_last (reference PublicInputs::from_vec,
    recursive_verifier.rs:79-104)."""
    builder, pt, state_before, ctl_challenges = wrapper_builder(
        stark, cross_table_lookups, table, degree_bits, inner_config,
        circuit_config)
    data = builder.build(device=device)
    return TableWrapperCircuit(
        data=data, session=ProverSession(data, device, timing=timing),
        proof_target=pt,
        state_before=state_before,
        ctl_challenge_targets=[(c.beta, c.gamma) for c in ctl_challenges])


def wrapper_builder(stark: Stark, cross_table_lookups: List[CrossTableLookup],
                    table: int, degree_bits: int, inner_config,
                    circuit_config: Optional[CircuitConfig] = None):
    """recursive_stark_circuit's circuit, unbuilt: (builder, proof
    targets, the state-before targets, the CTL challenges' targets)."""
    circuit_config = (circuit_config
                      or CircuitConfig.standard_recursion_config())
    builder = CircuitBuilder(circuit_config)
    num_challenges = inner_config.num_challenges
    num_perm_zs = (stark.num_permutation_batches(inner_config)
                   if stark.uses_permutation_args() else 0)
    layout = ctl_zs_layout(cross_table_lookups, table, num_challenges)
    num_ctl_zs = len(layout)
    pt = add_virtual_evm_stark_proof(builder, stark, inner_config,
                                     degree_bits, num_perm_zs, num_ctl_zs)

    ctl_challenges = [
        GrandProductChallengeTarget(beta=builder.add_virtual_target(),
                                    gamma=builder.add_virtual_target())
        for _ in range(num_challenges)]
    state_before = builder.add_virtual_targets(pos.WIDTH)

    # --- the table's Fiat-Shamir transcript segment -----------------------
    ch = RecursiveChallenger.from_state(builder, state_before)
    challenge_sets = None
    if stark.uses_permutation_args():
        challenge_sets = []
        for _ in range(stark.permutation_batch_size()):
            chs = [PermutationChallengeTarget(ch.get_challenge(builder),
                                              ch.get_challenge(builder))
                   for _ in range(num_challenges)]
            challenge_sets.append(PermutationChallengeSetTarget(chs))
    ch.observe_cap(pt.permutation_ctl_zs_cap)
    alphas = ch.get_n_challenges(builder, num_challenges)
    ch.observe_cap(pt.quotient_polys_cap)
    zeta = ch.get_extension_challenge(builder)
    openings_t = pt.openings.to_fri_openings(builder)
    ch.observe_openings(openings_t)
    fri_chals = ch.fri_challenges(
        builder, pt.opening_proof.commit_phase_merkle_caps,
        pt.opening_proof.final_poly, pt.opening_proof.pow_witness,
        inner_config.fri_config)
    state_after = ch.compact(builder)

    # --- constraint evaluation at zeta ------------------------------------
    alg = CircuitExtAlgebra(builder)
    vars = StarkEvaluationVars(
        local_values=list(pt.openings.local_values),
        next_values=list(pt.openings.next_values),
        public_inputs=[])
    one = builder.one_extension()
    zeta_pow_deg = builder.exp_power_of_2_extension(zeta, degree_bits)
    z_h_zeta = builder.sub_extension(zeta_pow_deg, one)
    l_0, l_last = _eval_l_0_and_l_last_circuit(builder, degree_bits, zeta,
                                               z_h_zeta)
    g = gl.primitive_root_of_unity(degree_bits)
    z_last = builder.sub_extension(
        zeta, builder.constant_extension((gl.s_inv(g), 0)))
    consumer = ConstraintConsumer(
        alg, [builder.convert_to_ext(a) for a in alphas], z_last, l_0, l_last)
    stark.eval(alg, vars, consumer)
    perm_ctl_zs = list(pt.openings.permutation_ctl_zs)
    perm_ctl_zs_next = list(pt.openings.permutation_ctl_zs_next)
    if stark.uses_permutation_args():
        _eval_permutation_checks_circuit(
            builder, alg, stark, inner_config, vars,
            perm_ctl_zs[:num_perm_zs], perm_ctl_zs_next[:num_perm_zs],
            challenge_sets, consumer)
    _eval_ctl_checks_circuit(builder, alg, vars, layout,
                             perm_ctl_zs[num_perm_zs:],
                             perm_ctl_zs_next[num_perm_zs:],
                             ctl_challenges, consumer)
    vanishing = consumer.accumulators()

    qdf = stark.quotient_degree_factor()
    for i in range(num_challenges):
        chunk = pt.openings.quotient_polys[i * qdf:(i + 1) * qdf]
        recombined = ReducingFactorTarget(zeta_pow_deg).reduce(chunk, builder)
        builder.connect_extension(vanishing[i],
                                  builder.mul_extension(z_h_zeta, recombined))

    instance = _evm_fri_instance_target(builder, stark, zeta, g, num_perm_zs,
                                        num_ctl_zs, inner_config)
    builder.verify_fri_proof_circuit(
        instance, openings_t, fri_chals,
        [pt.trace_cap, pt.permutation_ctl_zs_cap, pt.quotient_polys_cap],
        pt.opening_proof, inner_config.fri_params(degree_bits))

    # --- public inputs -----------------------------------------------------
    for h in pt.trace_cap:
        builder.register_public_inputs(list(h))
    for c in ctl_challenges:
        builder.register_public_inputs([c.beta, c.gamma])
    builder.register_public_inputs(state_before)
    builder.register_public_inputs(list(state_after))
    builder.register_public_inputs(list(pt.openings.ctl_zs_last))
    return builder, pt, state_before, ctl_challenges


@dataclass
class PublicInputs:
    """A wrapper's public inputs, decoded (reference
    recursive_verifier.rs:79-104)."""
    trace_cap: List[List[int]]
    ctl_challenges: GrandProductChallengeSet
    challenger_state_before: List[int]
    challenger_state_after: List[int]
    ctl_zs_last: List[int]

    @staticmethod
    def from_vec(v: List[int], config) -> "PublicInputs":
        it = iter(v)
        cap = [[next(it) for _ in range(4)]
               for _ in range(1 << config.fri_config.cap_height)]
        challenges = GrandProductChallengeSet(challenges=[
            GrandProductChallenge(beta=next(it), gamma=next(it))
            for _ in range(config.num_challenges)])
        before = [next(it) for _ in range(pos.WIDTH)]
        after = [next(it) for _ in range(pos.WIDTH)]
        return PublicInputs(cap, challenges, before, after, list(it))


def replay_challenger_states(all_stark: AllStark, all_proof: AllProof,
                             config):
    """Replay the tables' shared transcript on the host: the CTL challenge
    set and each table's sponge states (before, after) its part."""
    ch = Challenger()
    for p in all_proof.stark_proofs:
        ch.observe_cap(p.trace_cap)
    ctl_challenge_set = get_grand_product_challenge_set(
        ch, config.num_challenges)
    states = []
    for stark, proof, db in zip(all_stark.starks, all_proof.stark_proofs,
                                all_proof.degree_bits):
        before = [int(x) for x in ch.compact()]
        if stark.uses_permutation_args():
            get_n_permutation_challenge_sets(ch, config.num_challenges,
                                             stark.permutation_batch_size())
        ch.observe_cap(proof.permutation_ctl_zs_cap)
        ch.get_n_challenges(config.num_challenges)
        ch.observe_cap(proof.quotient_polys_cap)
        ch.get_extension_challenge()
        observe_openings(ch, proof.openings.to_fri_openings())
        native_fri_challenges(ch, proof.opening_proof.commit_phase_merkle_caps,
                              proof.opening_proof.final_poly,
                              proof.opening_proof.pow_witness, db,
                              config.fri_config)
        after = [int(x) for x in ch.compact()]
        states.append((before, after))
    return ctl_challenge_set, states


def table_witness(wc: TableWrapperCircuit, proof, state_before,
                  ctl_challenges: GrandProductChallengeSet) -> PartialWitness:
    """The wrapper's inputs: the table's proof, the transcript's state
    before the table and the CTL challenges."""
    pw = PartialWitness()
    set_evm_stark_proof_target(pw, wc.proof_target, proof)
    for t, v in zip(wc.state_before, state_before):
        pw.set_target(t, v)
    for (bt, gt), chal in zip(wc.ctl_challenge_targets,
                              ctl_challenges.challenges):
        pw.set_target(bt, chal.beta)
        pw.set_target(gt, chal.gamma)
    return pw


def wrap_table_proof(wc: TableWrapperCircuit, proof, state_before,
                     ctl_challenges: GrandProductChallengeSet, rng=None,
                     timing=None):
    """Prove one table's wrapper circuit, in its session; `rng` seeds the
    witness's randomness, `timing` goes to the session's prove."""
    return wc.session.prove(
        table_witness(wc, proof, state_before, ctl_challenges), rng=rng,
        timing=timing)


def wrap_all_proof(all_stark: AllStark, all_proof: AllProof, config,
                   circuits: Optional[Dict[int, TableWrapperCircuit]] = None,
                   device=None, rng=None
                   ) -> Tuple[list, List[TableWrapperCircuit]]:
    """Prove every table's wrapper circuit: the plonky2 proofs of the
    reference's RecursiveAllProof (recursive_verifier.rs:321-384).  The
    circuits missing from `circuits` are built on `device` (default cuda)
    and added to it."""
    ctl_challenge_set, states = replay_challenger_states(all_stark, all_proof,
                                                         config)
    circuits = circuits if circuits is not None else {}
    wrapped = []
    out_circuits = []
    for i, (stark, proof, db) in enumerate(zip(all_stark.starks,
                                               all_proof.stark_proofs,
                                               all_proof.degree_bits)):
        wc = circuits.get(i)
        if wc is None:
            wc = recursive_stark_circuit(stark, all_stark.cross_table_lookups,
                                         i, db, config, device=device)
            circuits[i] = wc
        wrapped.append(wrap_table_proof(wc, proof, states[i][0],
                                        ctl_challenge_set, rng=rng))
        out_circuits.append(wc)
    return wrapped, out_circuits


def verify_recursive_all_proof(wrapped_proofs: list,
                               circuits: List[TableWrapperCircuit],
                               cross_table_lookups: List[CrossTableLookup],
                               config) -> None:
    """The aggregate check on the host, then each wrapper's proof
    (reference recursive_verifier.rs:110-160); raises
    EvmVerificationError or the verifiers' errors."""
    pis = [PublicInputs.from_vec(p.public_inputs, config)
           for p in wrapped_proofs]
    ch = Challenger()
    for pi in pis:
        for h in pi.trace_cap:
            ch.observe_hash(h)
    ctl_challenges = get_grand_product_challenge_set(ch, config.num_challenges)
    for pi in pis:
        _ensure(pi.ctl_challenges == ctl_challenges,
                "wrapper used wrong CTL challenges")
    state = [int(x) for x in ch.compact()]
    _ensure(state == pis[0].challenger_state_before,
            "challenger state mismatch at table 0")
    for i in range(1, len(pis)):
        _ensure(pis[i].challenger_state_before
                == pis[i - 1].challenger_state_after,
                f"challenger state does not chain into table {i}")
    verify_cross_table_lookups(cross_table_lookups,
                               [pi.ctl_zs_last for pi in pis],
                               ctl_challenges, config)
    for proof, wc in zip(wrapped_proofs, circuits):
        wc.data.verify(proof)
