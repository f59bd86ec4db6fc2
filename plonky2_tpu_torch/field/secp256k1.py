"""The secp256k1 base and scalar fields: the port's copy of
plonky2_tpu/field/secp256k1.py (reference field/src/secp256k1_base.rs,
secp256k1_scalar.rs).

Non-native field elements are Python ints reduced mod their order; their
in-circuit form is gadgets/nonnative.py.  This module holds the fields'
constants and scalar helpers.
"""
from __future__ import annotations

SECP256K1_BASE_ORDER = \
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP256K1_SCALAR_ORDER = \
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141

# the multiplicative group generators (reference secp256k1_base.rs,
# secp256k1_scalar.rs)
BASE_MULTIPLICATIVE_GROUP_GENERATOR = 3
SCALAR_MULTIPLICATIVE_GROUP_GENERATOR = 7

# the two-adicity of p - 1 and of n - 1
BASE_TWO_ADICITY = 1
SCALAR_TWO_ADICITY = 6


def base_add(a: int, b: int) -> int:
    return (a + b) % SECP256K1_BASE_ORDER


def base_mul(a: int, b: int) -> int:
    return a * b % SECP256K1_BASE_ORDER


def base_inverse(a: int) -> int:
    return pow(a, -1, SECP256K1_BASE_ORDER)


def scalar_add(a: int, b: int) -> int:
    return (a + b) % SECP256K1_SCALAR_ORDER


def scalar_mul(a: int, b: int) -> int:
    return a * b % SECP256K1_SCALAR_ORDER


def scalar_inverse(a: int) -> int:
    return pow(a, -1, SECP256K1_SCALAR_ORDER)


def base_to_scalar(x: int) -> int:
    """A base field element read as a scalar (the reference's
    non-canonical biguint reinterpretation, curve_types.rs:280)."""
    return x % SECP256K1_SCALAR_ORDER


def scalar_to_base(x: int) -> int:
    return x % SECP256K1_BASE_ORDER
