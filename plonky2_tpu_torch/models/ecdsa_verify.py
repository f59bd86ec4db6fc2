"""secp256k1 ECDSA verification in one circuit (tests/test_ecdsa_verify.py
of the JAX package; reference ecdsa/src/gadgets/ecdsa.rs,
test_ecdsa_circuit_narrow).

A message, a key and a nonce drawn from ``random.Random(seed)`` in the
JAX test's order; the signature, the message and the public key are the
circuit's constants, and ``verify_message_circuit`` checks the signature
at full width (256-bit scalars: a fixed-base product of the generator,
a GLV product of the key, their sum).  Under standard_ecc_config (136
wires) the circuit places 98,660 gates before ``build()`` adds its
constant and public-input gates, and has 2^17 rows.

``place_ecdsa_verify`` takes any builder and the curve and gadgets
modules of its package, so that the JAX package's builder can build the
same circuit (the tests hold the two against each other);
``build_ecdsa_circuit`` builds it with the port's.  Its witness is
generated on the host (the U32, comparison and non-native generators
have no device batch).
"""
from __future__ import annotations

import random
from typing import NamedTuple

from ..ecdsa import curve, gadgets
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig

SEED = 0xECD5A
GATES = 98660
LOG_N = 17


class EcdsaInputs(NamedTuple):
    msg: int
    pk: object          # the package's curve.AffinePoint
    sig: object         # the package's curve.ECDSASignature


def ecdsa_inputs(cv, seed: int = SEED, wrong_signature: bool = False
                 ) -> EcdsaInputs:
    """The JAX test's message, public key and signature in `cv`'s (the
    package's ecdsa/curve module's) classes; with `wrong_signature`,
    s + 1 mod n in place of s, which no key verifies."""
    rng = random.Random(seed)
    n = cv.SECP256K1_N
    msg = rng.randrange(n)
    sk = rng.randrange(1, n)
    pk = cv.public_key(sk)
    sig = cv.sign_message(msg, sk, k=rng.randrange(1, n))
    if wrong_signature:
        sig = cv.ECDSASignature(r=sig.r, s=(sig.s + 1) % n)
    return EcdsaInputs(msg, pk, sig)


def place_ecdsa_verify(b, cv, gd, inputs: EcdsaInputs) -> None:
    """The verification of `inputs` on `b`; `cv` and `gd` are the ecdsa
    curve and gadgets modules of the builder's package."""
    n = cv.SECP256K1_N
    msg_t = b.constant_nonnative(inputs.msg, n)
    pk_t = gd.ECDSAPublicKeyTarget(b.constant_affine_point(inputs.pk))
    sig_t = gd.ECDSASignatureTarget(r=b.constant_nonnative(inputs.sig.r, n),
                                    s=b.constant_nonnative(inputs.sig.s, n))
    gd.verify_message_circuit(b, msg_t, sig_t, pk_t)


def ecdsa_builder(seed: int = SEED, wrong_signature: bool = False):
    """The circuit on the port's builder under standard_ecc_config,
    unbuilt: (builder, its EcdsaInputs)."""
    inputs = ecdsa_inputs(curve, seed, wrong_signature)
    b = CircuitBuilder(CircuitConfig.standard_ecc_config())
    place_ecdsa_verify(b, curve, gadgets, inputs)
    return b, inputs


def build_ecdsa_circuit(device=None, seed: int = SEED,
                        wrong_signature: bool = False):
    """(CircuitData built on `device` (default cuda), its PartialWitness,
    which is empty: every input is a constant, EcdsaInputs)."""
    b, inputs = ecdsa_builder(seed, wrong_signature)
    return b.build(device=device), PartialWitness(), inputs
