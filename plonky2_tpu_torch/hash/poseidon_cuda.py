"""Wrappers for kernels K1 (leaf sponge) and K2 (one Merkle level).

K1 replaces plonky2_tpu/hash/poseidon_pallas.py:hash_leaves_cols_pallas and
K2 replaces poseidon_pallas.py:compress_pairs_cols_pallas; their CUDA source
is csrc/poseidon.cu, whose header note gives the bound on an H100 (integer
operations) and the design.  Each wrapper takes the plain version beside it
(hash/poseidon.py) for a CPU tensor only; a CUDA tensor launches the kernel
or the call raises.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import kernels
from . import poseidon as pos


def hash_leaves_cols_cuda(leaves: torch.Tensor) -> torch.Tensor:
    """K1: leaves (L, N) int64, leaf i = column i -> digests (4, N)."""
    kernels.check_field_tensor(leaves, "leaves", ndim=2)
    if kernels.on_cpu(leaves):
        return pos.hash_leaves_cols(leaves)
    kernels.check_kernel_operand(leaves, "leaves", leaves.device)
    L, N = leaves.shape
    out = torch.empty((4, N), dtype=torch.int64, device=leaves.device)
    kernels.call("plk_hash_leaves", leaves.data_ptr(), out.data_ptr(), L, N,
                 leaves.device.index, kernels.stream_of(leaves))
    hash_leaves_cols_cuda.launches += 1
    return out


hash_leaves_cols_cuda.launches = 0


def compress_level(level: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: parent k = compress(level[:, 2k], level[:, 2k+1])."""
    return pos.compress_pairs_cols(level[:, 0::2], level[:, 1::2])


def compress_level_cuda(level: torch.Tensor) -> torch.Tensor:
    """K2: one Merkle level, (4, 2m) children -> (4, m) parents."""
    kernels.check_field_tensor(level, "level", ndim=2)
    if level.shape[0] != 4 or level.shape[1] % 2:
        raise ValueError(f"level: expected (4, 2m), got {tuple(level.shape)}")
    if kernels.on_cpu(level):
        return compress_level(level)
    kernels.check_kernel_operand(level, "level", level.device)
    m = level.shape[1] // 2
    out = torch.empty((4, m), dtype=torch.int64, device=level.device)
    kernels.call("plk_compress_level", level.data_ptr(), out.data_ptr(), m,
                 level.device.index, kernels.stream_of(level))
    compress_level_cuda.launches += 1
    return out


compress_level_cuda.launches = 0
