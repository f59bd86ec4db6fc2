"""Bit-twiddling helpers (the port's copy of plonky2_tpu/utils/bits.py)."""
from __future__ import annotations

import numpy as np


def log2_strict(n: int) -> int:
    k = n.bit_length() - 1
    if n <= 0 or (1 << k) != n:
        raise ValueError(f"{n} is not a power of two")
    return k


def reverse_bits(x: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation perm with perm[i] = bit-reverse(i) over log2(n) bits."""
    bits = log2_strict(n)
    x = np.arange(n, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for _ in range(bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out
