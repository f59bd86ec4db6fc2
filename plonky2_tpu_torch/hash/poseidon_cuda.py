"""Wrappers for kernels K1 (leaf sponge), K2 (Merkle levels) and K7 (a
wave of the Poseidon gate's witness).

K1 replaces plonky2_tpu/hash/poseidon_pallas.py:hash_leaves_cols_pallas and
K2 replaces poseidon_pallas.py:compress_pairs_cols_pallas, in two forms: one
launch a wide level (``compress_level_cuda``) and one launch for the narrow
top of a tree (``compress_tail_cuda``).  Their CUDA source is
csrc/poseidon.cu, whose notes give the bounds on an H100 (integer operations
for K1 and a wide level, the latency of one permutation a level for the
narrow top) and the designs.  Each wrapper takes the plain version beside it
(hash/poseidon.py) for a CPU tensor only; a CUDA tensor launches the kernel
or the call raises.  ``<wrapper>.launches`` counts kernel launches.

K7 has no TPU kernel to replace (the JAX package computes it in XLA:
plonky2_tpu/hash/poseidon_wires_jax.py:poseidon_wire_batch); its plain
version is hash/poseidon_wires.py:poseidon_wires.
"""
from __future__ import annotations

import torch

from .. import kernels
from . import poseidon as pos
from . import poseidon_wires as pw


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


def compress_tail(level: torch.Tensor, n_levels: int) -> list:
    """Plain version of K2's narrow top: n_levels levels above `level`."""
    out = []
    for _ in range(n_levels):
        level = compress_level(level)
        out.append(level)
    return out


def compress_tail_cuda(level: torch.Tensor, n_levels: int) -> list:
    """K2's narrow top in one launch: (4, 2 m0) children -> the n_levels
    levels [(4, m0), (4, m0 / 2), ...], views of one buffer."""
    kernels.check_field_tensor(level, "level", ndim=2)
    if (level.shape[0] != 4 or n_levels < 1
            or level.shape[1] % (1 << n_levels)):
        raise ValueError(f"level: expected (4, 2m) with 2^{n_levels} "
                         f"dividing 2m and n_levels >= 1, got "
                         f"{tuple(level.shape)}")
    if kernels.on_cpu(level):
        return compress_tail(level, n_levels)
    kernels.check_kernel_operand(level, "level", level.device)
    m0 = level.shape[1] // 2
    sizes = [m0 >> k for k in range(n_levels)]
    out = torch.empty(4 * sum(sizes), dtype=torch.int64, device=level.device)
    kernels.call("plk_compress_tail", level.data_ptr(), out.data_ptr(), m0,
                 n_levels, level.device.index, kernels.stream_of(level))
    compress_tail_cuda.launches += 1
    return [v.view(4, m) for v, m in zip(out.split([4 * m for m in sizes]),
                                          sizes)]


compress_tail_cuda.launches = 0


def _check_index(t, name: str, rows: int, G: int, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 tensor")
    if tuple(t.shape) != (rows, G):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{(rows, G)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


def poseidon_wires_cuda(values: torch.Tensor, dep_idx: torch.Tensor,
                        out_idx: torch.Tensor, err: torch.Tensor) -> None:
    """K7, in place: the G rows of a Poseidon wave read their 12 inputs and
    swap wire at values[dep_idx] (int32, (13, G)) and write their 122 wires
    at values[out_idx] (int32, (122, G)); err (int32, (1,)) becomes nonzero
    if a swap wire is not 0 or 1."""
    kernels.check_field_tensor(values, "values", ndim=1)
    G = dep_idx.shape[-1]
    dev = values.device
    _check_index(dep_idx, "dep_idx", pw.WIDTH + 1, G, dev)
    _check_index(out_idx, "out_idx", pw.NUM_OUTPUT_WIRES, G, dev)
    if (not isinstance(err, torch.Tensor) or err.dtype != torch.int32
            or tuple(err.shape) != (1,) or err.device != dev):
        raise ValueError(f"err: expected an int32 tensor of shape (1,) on "
                         f"{dev}")
    if kernels.on_cpu(values):
        pw.poseidon_wires(values, dep_idx, out_idx, err)
        return
    kernels.check_kernel_operand(values, "values", dev)
    kernels.call("plk_poseidon_wires", values.data_ptr(), dep_idx.data_ptr(),
                 out_idx.data_ptr(), G, err.data_ptr(), dev.index,
                 kernels.stream_of(values))
    poseidon_wires_cuda.launches += 1


poseidon_wires_cuda.launches = 0
