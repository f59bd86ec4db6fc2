"""The prover: a proof's phases 2-8 from a witness matrix.

The port's counterpart of plonky2_tpu/plonk/prover.py:prove (:30-200), in
its order: the wires commitment; the transcript's circuit digest, public-
inputs hash and wires cap, then betas and gammas; the quotient round
(``quotient_round``, phases 3-6: partial products -> Z/PP commitment ->
the constraint program over the quotient coset, then the coset INTT ->
quotient commitment), drawing the alphas after the Z/PP cap; the quotient
cap, then zeta; the opening set, observed; the FRI opening proof
(fri/device_prover.py).  The witness comes from the caller (the witness
generators run before it, in runtime/session.py), with the circuit's data
from a plonk.prover_data.ProverData.

Every commitment's tree and the transcript are the circuit's hasher's
(``ProverData.hasher()``).  Under Poseidon the trees are hashed on the
device and the FRI's transcript runs there (the fused path).  Under the
non-algebraic Keccak configuration the LDEs, the quotient and the FRI
folds still run on the device, while the trees are hashed on the host
from the leaves brought down once a commitment, and the transcript and
the proof-of-work grind run on the host, as the JAX package runs them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import lies_on, resolve_device
from ..field import extension as ext
from ..field import goldilocks as gl
from ..fri.challenges import observe_openings
from ..fri.device_prover import device_prove_openings
from ..fri.oracle import PolynomialBatch, _on_device
from ..hash import poseidon as pos
from ..hash.hashers import POSEIDON_CONFIG
from ..iop.challenger import Challenger
from ..ops import ntt
from ..ops.partial_products import device_partial_products
from ..utils.timing import NoopTiming
from .proof import OpeningSet, Proof, ProofWithPublicInputs
from .quotient_program import DeviceQuotient


class QuotientRound(NamedTuple):
    zspp_values: torch.Tensor        # (nch * (1 + num_pp), degree)
    zspp_batch: PolynomialBatch
    quotient_values: torch.Tensor    # (nch, quotient-coset size)
    quotient_coeffs: torch.Tensor    # (nch, quotient-coset size)
    quotient_batch: PolynomialBatch  # of (nch * qdf, degree) chunks
    quotient: DeviceQuotient         # reusable by the next proof


def quotient_round(wires_values, wires_batch: PolynomialBatch, sigmas,
                   shape, program, cs_batch: PolynomialBatch,
                   public_inputs_hash, betas, gammas, alphas,
                   quotient: Optional[DeviceQuotient] = None,
                   chunk: Optional[int] = None,
                   device=None, hasher=POSEIDON_CONFIG) -> QuotientRound:
    """wires_values: the (num_wires, degree) witness the wires commitment
    was made from; sigmas: (num_routed_wires, degree) sigma values; shape:
    a CircuitShape; program: the circuit's quotient ConstraintProgram;
    cs_batch: the constants-sigmas commitment.  ``alphas`` is a list, or a
    function of the Z/PP commitment that returns them (the transcript
    observes its cap, then draws them).  ``quotient`` is the
    DeviceQuotient of an earlier call (made here when None, with lanes in
    chunks of ``chunk``).  The commitments' trees are the hasher's.  Runs
    on `device` (default cuda)."""
    dev = resolve_device(device)
    wires = _on_device(wires_values, dev)
    zspp = device_partial_products(wires, _on_device(sigmas, dev), betas,
                                   gammas, shape)
    zspp_batch = PolynomialBatch.from_values(
        zspp, shape.rate_bits, shape.zero_knowledge, shape.cap_height,
        device=dev, hasher=hasher)
    if callable(alphas):
        alphas = alphas(zspp_batch)
    if quotient is None:
        quotient = DeviceQuotient(shape, program, cs_batch, chunk=chunk,
                                  device=dev)
    values = quotient.evaluate(wires_batch, zspp_batch, public_inputs_hash,
                               betas, gammas, alphas)
    coeffs = ntt.coset_intt(values)
    chunks = coeffs.reshape(shape.num_quotient_polys, shape.degree)
    quotient_batch = PolynomialBatch.from_coeffs(
        chunks, shape.rate_bits, shape.zero_knowledge, shape.cap_height,
        device=dev, hasher=hasher)
    return QuotientRound(zspp, zspp_batch, values, coeffs, quotient_batch,
                         quotient)


class ProverContext:
    """What every proof of one circuit on one device reuses: the
    constants-sigmas commitment, the sigma values on the device and the
    quotient context (the JAX package keeps the same in its prover data
    and session)."""

    def __init__(self, data, device=None, chunk: Optional[int] = None,
                 cs_batch: Optional[PolynomialBatch] = None):
        """``cs_batch``: the constants-sigmas commitment already made on
        this device (plonk/circuit_builder.py:build makes one); committed
        here from ``data.cs_coeffs`` when None."""
        self.device = resolve_device(device)
        s = data.shape
        if cs_batch is None:
            cs_batch = PolynomialBatch.from_coeffs(
                data.cs_coeffs, s.rate_bits, False, s.cap_height,
                device=self.device, hasher=data.hasher())
        elif not lies_on(cs_batch.leaves_dev, self.device):
            raise ValueError(f"the constants-sigmas commitment lies on "
                             f"{cs_batch.leaves_dev.device}, the context "
                             f"on {self.device}")
        self.cs_batch = cs_batch
        self.sigmas = _on_device(data.sigmas, self.device)
        self.quotient = DeviceQuotient(s, data.program, self.cs_batch,
                                       chunk=chunk, device=self.device)


def start_transcript(data, public_inputs_hash, wires_cap):
    """The transcript up to the permutation challenges: the circuit digest,
    the public-inputs hash and the wires cap observed, then the betas and
    the gammas drawn.  Returns (challenger, betas, gammas)."""
    nch = data.shape.num_challenges
    challenger = Challenger(permutation=data.hasher().permute)
    challenger.observe_hash(data.circuit_digest)
    challenger.observe_hash(public_inputs_hash)
    challenger.observe_cap(wires_cap)
    betas = challenger.get_n_challenges(nch)
    return challenger, betas, challenger.get_n_challenges(nch)


def opening_round(challenger, oracles, data, timing=None):
    """Phases 7-8: observe the quotient cap (of ``oracles[3]``), draw zeta,
    open the four oracles (constants-sigmas, wires, Z/PP, quotient) at it
    and the Zs at g * zeta, observe the values and prove them with FRI.
    Returns (OpeningSet, FriProof)."""
    timing = timing if timing is not None else NoopTiming()
    s = data.shape
    challenger.observe_cap(oracles[3].merkle_tree.cap)
    zeta = challenger.get_extension_challenge()
    if ext.s_exp(zeta, s.degree) == ext.ONE:
        raise RuntimeError("the opening point is in the subgroup")
    with timing.scope("openings"):
        openings = OpeningSet.new(
            zeta, gl.primitive_root_of_unity(s.degree_bits), *oracles, data)
        fri_openings = openings.to_fri_openings()
        observe_openings(challenger, fri_openings)
    return openings, device_prove_openings(
        data.get_fri_instance(zeta), oracles, fri_openings, challenger,
        data.fri_params, timing, data.hasher())


def prove(data, witness, context: Optional[ProverContext] = None,
          device=None, timing=None) -> ProofWithPublicInputs:
    """The proof of the (num_wires, degree) `witness` (numpy uint64 or an
    int64 tensor) for the circuit `data` (a ProverData).  ``context`` is
    the ProverContext of an earlier proof on the same device (made here
    when None); ``timing.scope(name)`` wraps each stage when given.  Runs
    on `device` (default cuda)."""
    timing = timing if timing is not None else NoopTiming()
    dev = resolve_device(device)
    if context is None:
        context = ProverContext(data, dev)
    s = data.shape
    nch = s.num_challenges
    gc = data.hasher()
    public_inputs = data.public_inputs(witness)
    pih = pos.hash_no_pad(np.array(public_inputs, dtype=np.uint64))
    wires = _on_device(witness, dev)
    with timing.scope("wires commitment"):
        wires_batch = PolynomialBatch.from_values(
            wires, s.rate_bits, s.zero_knowledge, s.cap_height, device=dev,
            hasher=gc)

    challenger, betas, gammas = start_transcript(
        data, pih, wires_batch.merkle_tree.cap)

    def alphas(zspp_batch):
        challenger.observe_cap(zspp_batch.merkle_tree.cap)
        return challenger.get_n_challenges(nch)

    with timing.scope("quotient round"):
        q = quotient_round(wires, wires_batch, context.sigmas, s,
                           data.program, context.cs_batch, pih, betas,
                           gammas, alphas, quotient=context.quotient,
                           device=dev, hasher=gc)
    del wires
    openings, opening_proof = opening_round(
        challenger, [context.cs_batch, wires_batch, q.zspp_batch,
                     q.quotient_batch], data, timing)
    return ProofWithPublicInputs(
        proof=Proof(wires_cap=wires_batch.merkle_tree.cap,
                    plonk_zs_partial_products_cap=q.zspp_batch.merkle_tree.cap,
                    quotient_polys_cap=q.quotient_batch.merkle_tree.cap,
                    openings=openings, opening_proof=opening_proof),
        public_inputs=public_inputs)
