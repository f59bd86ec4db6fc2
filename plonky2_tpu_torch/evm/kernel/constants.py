"""The port's copy of plonky2_tpu/evm/kernel/constants.py.

Constants available to kernel assembly via `@NAME`
(reference evm/src/cpu/kernel/constants/mod.rs evm_constants)."""
from __future__ import annotations

from typing import Dict

from ..memory import Segment

# secp256k1 + bn254 curve constants (reference constants/mod.rs EC_CONSTANTS)
EC_CONSTANTS = {
    "U256_MAX": (1 << 256) - 1,
    "SECP_BASE":
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    "SECP_SCALAR":
        0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    "BN_BASE":
        0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47,
    "SECP_GX":
        0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    "SECP_GY":
        0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
    "U160": 1 << 160,
}

# intrinsic gas etc. (reference constants/mod.rs GAS_CONSTANTS)
GAS_CONSTANTS = {
    "GAS_TX": 21_000,
    "GAS_TXDATAZERO": 4,
    "GAS_TXDATANONZERO": 16,
    "GAS_TXCREATE": 32_000,
}


def evm_constants() -> Dict[str, int]:
    import re
    c: Dict[str, int] = {}
    c.update(EC_CONSTANTS)
    c.update(GAS_CONSTANTS)
    for seg in Segment:
        c[f"SEGMENT_{seg.name.upper()}"] = int(seg)
        # reference-style snake-case alias (segments.rs:73-90), e.g.
        # GlobalMetadata -> SEGMENT_GLOBAL_METADATA
        snake = re.sub(r"(?<!^)(?=[A-Z0-9])", "_", seg.name).upper()
        c[f"SEGMENT_{snake}"] = int(seg)
    return c
