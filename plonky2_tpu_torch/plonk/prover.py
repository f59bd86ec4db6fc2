"""The prover's quotient round (phases 3-6 of a proof).

The port's counterpart of plonky2_tpu/plonk/prover.py:prove, :110-163:
partial products -> Z/PP commitment -> quotient (the constraint program
over the quotient coset, then the coset INTT) -> quotient commitment.  The
host ``Challenger`` is not ported yet, so the challenges are arguments.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import resolve_device
from ..fri.oracle import PolynomialBatch, _on_device
from ..ops import ntt
from ..ops.partial_products import device_partial_products
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
                   device=None) -> QuotientRound:
    """wires_values: the (num_wires, degree) witness the wires commitment
    was made from; sigmas: (num_routed_wires, degree) sigma values; shape:
    a CircuitShape; program: the circuit's quotient ConstraintProgram;
    cs_batch: the constants-sigmas commitment.  ``quotient`` is the
    DeviceQuotient of an earlier call (made here when None, with lanes in
    chunks of ``chunk``).  Runs on `device` (default cuda)."""
    dev = resolve_device(device)
    wires = _on_device(wires_values, dev)
    zspp = device_partial_products(wires, _on_device(sigmas, dev), betas,
                                   gammas, shape)
    zspp_batch = PolynomialBatch.from_values(
        zspp, shape.rate_bits, shape.zero_knowledge, shape.cap_height,
        device=dev)
    if quotient is None:
        quotient = DeviceQuotient(shape, program, cs_batch, chunk=chunk,
                                  device=dev)
    values = quotient.evaluate(wires_batch, zspp_batch, public_inputs_hash,
                               betas, gammas, alphas)
    coeffs = ntt.coset_intt(values)
    chunks = coeffs.reshape(shape.num_quotient_polys, shape.degree)
    quotient_batch = PolynomialBatch.from_coeffs(
        chunks, shape.rate_bits, shape.zero_knowledge, shape.cap_height,
        device=dev)
    return QuotientRound(zspp, zspp_batch, values, coeffs, quotient_batch,
                         quotient)
