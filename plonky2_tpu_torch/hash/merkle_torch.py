"""Device-side Merkle construction over column-major leaves.

The port's counterpart of plonky2_tpu/hash/merkle_jax.py.  Leaves are (L, N)
(leaf i = column i) and digest levels are (4, N_k).  Leaf columns of at most
4 elements are zero-padded instead of hashed.  Every compress level goes
through K2: the JAX package's chunked path compresses with plain XLA and its
fused path with the Pallas kernel, which is the same function.
"""
from __future__ import annotations

import torch

from ..utils.bits import log2_strict
from . import poseidon_cuda as pc


def hash_leaves_or_noop_cols(leaves: torch.Tensor) -> torch.Tensor:
    """leaves (L, N) -> (4, N) digests."""
    L = leaves.shape[0]
    if L <= 4:
        return torch.nn.functional.pad(leaves, (0, 0, 0, 4 - L))
    return pc.hash_leaves_cols_cuda(leaves)


def build_digest_levels(leaves: torch.Tensor, cap_height: int) -> list:
    """leaves (L, N) -> [(4, N), (4, N/2), ..., (4, 2^cap_height)]."""
    bits = log2_strict(leaves.shape[1])
    if cap_height > bits:
        raise ValueError(f"cap height {cap_height} above tree height {bits}")
    levels = [hash_leaves_or_noop_cols(leaves)]
    for _ in range(bits - cap_height):
        levels.append(pc.compress_level_cuda(levels[-1]))
    return levels
