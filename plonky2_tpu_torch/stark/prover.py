"""The STARK prover: the port's counterpart of plonky2_tpu/stark/prover.py
(reference starky/src/prover.rs), with the same transcript and proof.

The trace is committed with fri/oracle.py:PolynomialBatch (K3/K5, then
K1 and K2); the permutation Z polynomials are torch ops where the trace
lies; the quotient is the table's compiled constraint program on K6
(stark/quotient_program.py) and a coset INTT (K3); the openings and the
FRI proof are fri/device_prover.py:device_prove_openings (the composition,
the fused FRI with the transcript on the card, K9, and the grind, K8)."""
from __future__ import annotations

from .. import resolve_device
from ..field import extension as ext
from ..field import goldilocks as gl
from ..fri.challenges import observe_openings
from ..fri.device_prover import device_prove_openings
from ..fri.oracle import PolynomialBatch, _on_device
from ..iop.challenger import Challenger
from ..utils.bits import log2_strict
from ..utils.timing import NoopTiming
from .permutation import (compute_permutation_z_polys,
                          get_n_permutation_challenge_sets)
from .proof import StarkOpeningSet, StarkProof, StarkProofWithPublicInputs
from .quotient_program import (quotient_context, quotient_scalars,
                               stark_program)
from .stark import Stark


def prove(stark: Stark, config, trace, public_inputs, device=None,
          timing=None) -> StarkProofWithPublicInputs:
    """trace: (COLUMNS, degree) values (numpy uint64 or an int64 tensor);
    public_inputs: a list of ints.  Runs on `device` (default cuda)."""
    timing = timing if timing is not None else NoopTiming()
    dev = resolve_device(device)
    if trace.shape[0] != stark.COLUMNS:
        raise ValueError(f"trace has {trace.shape[0]} columns, the stark "
                         f"{stark.COLUMNS}")
    if len(public_inputs) != stark.PUBLIC_INPUTS:
        raise ValueError(f"{len(public_inputs)} public inputs, expected "
                         f"{stark.PUBLIC_INPUTS}")
    degree = trace.shape[1]
    degree_bits = log2_strict(degree)
    fri_params = config.fri_params(degree_bits)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    if fri_params.total_arities() > degree_bits + rate_bits - cap_height:
        raise ValueError("the FRI reductions exceed the LDE below the cap")
    program = stark_program(stark, config)

    trace = _on_device(trace, dev)
    with timing.scope("trace commitment"):
        trace_commitment = PolynomialBatch.from_values(
            trace, rate_bits, False, cap_height, device=dev)
    challenger = Challenger()
    challenger.observe_cap(trace_commitment.merkle_tree.cap)

    zs_commitment = None
    challenge_sets = None
    if stark.uses_permutation_args():
        challenge_sets = get_n_permutation_challenge_sets(
            challenger, config.num_challenges,
            stark.permutation_batch_size())
        with timing.scope("Z polynomials"):
            z_polys = compute_permutation_z_polys(stark, config, trace,
                                                  challenge_sets)
            zs_commitment = PolynomialBatch.from_values(
                z_polys, rate_bits, False, cap_height, device=dev)
        challenger.observe_cap(zs_commitment.merkle_tree.cap)
    del trace

    alphas = challenger.get_n_challenges(config.num_challenges)
    with timing.scope("quotient"):
        chunks = quotient_context(
            stark, program, degree_bits, rate_bits, str(dev)).compute(
            trace_commitment, zs_commitment,
            quotient_scalars(alphas, challenge_sets,
                             public_inputs=public_inputs))
        quotient_commitment = PolynomialBatch.from_coeffs(
            chunks, rate_bits, False, cap_height, device=dev)
    challenger.observe_cap(quotient_commitment.merkle_tree.cap)

    zeta = challenger.get_extension_challenge()
    if ext.s_exp(zeta, degree) == ext.ONE:
        raise RuntimeError("the opening point is in the subgroup")
    g = gl.primitive_root_of_unity(degree_bits)
    with timing.scope("openings"):
        openings = StarkOpeningSet.new(zeta, g, trace_commitment,
                                       zs_commitment, quotient_commitment)
        fri_openings = openings.to_fri_openings()
        observe_openings(challenger, fri_openings)
    oracles = [trace_commitment]
    if zs_commitment is not None:
        oracles.append(zs_commitment)
    oracles.append(quotient_commitment)
    opening_proof = device_prove_openings(
        stark.fri_instance(zeta, g, config), oracles, fri_openings,
        challenger, fri_params, timing)
    return StarkProofWithPublicInputs(
        proof=StarkProof(
            trace_cap=trace_commitment.merkle_tree.cap,
            permutation_zs_cap=(zs_commitment.merkle_tree.cap
                                if zs_commitment is not None else None),
            quotient_polys_cap=quotient_commitment.merkle_tree.cap,
            openings=openings, opening_proof=opening_proof),
        public_inputs=[int(p) for p in public_inputs])
