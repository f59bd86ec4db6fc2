"""Wrappers for kernels K1 (leaf sponge), K2 (Merkle levels), K7 (the
Poseidon gate's witness waves) and K8 (the FRI proof-of-work grind).

K1 replaces plonky2_tpu/hash/poseidon_pallas.py:hash_leaves_cols_pallas and
K2 replaces poseidon_pallas.py:compress_pairs_cols_pallas, in two forms: one
launch a wide level (``compress_level_cuda``) and one launch for the narrow
top of a tree (``compress_tail_cuda``).  Their CUDA source is
csrc/poseidon.cu, whose notes give the bounds on an H100 (integer operations
for K1 and a wide level, the latency of one permutation a level for the
narrow top) and the designs.  Each wrapper takes the plain version beside it
(hash/poseidon.py) for a CPU tensor only; a CUDA tensor launches the kernel
or the call raises.  ``<wrapper>.launches`` counts kernel launches.

K7 and K8 have no TPU kernel to replace: the JAX package computes a wave
in XLA (plonky2_tpu/hash/poseidon_wires_jax.py:poseidon_wire_batch) and
grinds in XLA inside its fused FRI (plonky2_tpu/fri/device_prover.py:
_fused_fri_fn).  K7's plain version is hash/poseidon_wires.py:
poseidon_wires_waves, K8's ``pow_grind`` below.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from ..field import gf
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


def _check_index(t, name: str, rows: int, R: int, device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name}: expected an int32 tensor")
    if tuple(t.shape) != (rows, R):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{(rows, R)}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor on {device}")


@functools.lru_cache(maxsize=None)
def _offsets_on(offsets: tuple, device: torch.device) -> torch.Tensor:
    """A run's wave offsets on its device, uploaded once per run."""
    return torch.tensor(offsets, dtype=torch.int64, device=device)


def poseidon_wires_waves_cuda(values: torch.Tensor, dep_idx: torch.Tensor,
                              out_idx: torch.Tensor, offsets,
                              err: torch.Tensor) -> None:
    """K7, in place: a run of consecutive Poseidon waves in one launch.
    Wave v is the columns [offsets[v], offsets[v + 1]) of dep_idx (int32,
    (13, R)) and out_idx (int32, (122, R)): its rows read their 12 inputs
    and swap wire at values[dep_idx] and write their 122 wires at
    values[out_idx], after every wave before it.  err (int32, (1,))
    becomes nonzero if a swap wire is not 0 or 1."""
    kernels.check_field_tensor(values, "values", ndim=1)
    R = dep_idx.shape[-1]
    dev = values.device
    _check_index(dep_idx, "dep_idx", pw.WIDTH + 1, R, dev)
    _check_index(out_idx, "out_idx", pw.NUM_OUTPUT_WIRES, R, dev)
    offsets = tuple(int(o) for o in offsets)
    if (len(offsets) < 2 or offsets[0] < 0 or offsets[-1] > R
            or any(b < a for a, b in zip(offsets, offsets[1:]))):
        raise ValueError(f"offsets: expected a rising sequence in [0, {R}] "
                         f"of at least 2, got {offsets}")
    if (not isinstance(err, torch.Tensor) or err.dtype != torch.int32
            or tuple(err.shape) != (1,) or err.device != dev):
        raise ValueError(f"err: expected an int32 tensor of shape (1,) on "
                         f"{dev}")
    if kernels.on_cpu(values):
        pw.poseidon_wires_waves(values, dep_idx, out_idx, offsets, err)
        return
    kernels.check_kernel_operand(values, "values", dev)
    max_rows = max(b - a for a, b in zip(offsets, offsets[1:]))
    kernels.call("plk_poseidon_wires_waves", values.data_ptr(),
                 dep_idx.data_ptr(), out_idx.data_ptr(),
                 _offsets_on(offsets, dev).data_ptr(), len(offsets) - 1, R,
                 max_rows, err.data_ptr(), dev.index,
                 kernels.stream_of(values))
    poseidon_wires_waves_cuda.launches += 1


poseidon_wires_waves_cuda.launches = 0

# K8: candidates a batch of the plain version, and the search's end
POW_BATCH = 1 << 12
POW_LIMIT = 1 << 40
_NONE = (1 << 64) - 1


def _check_grind(base, word: int, bits: int, start: int, limit: int) -> None:
    kernels.check_field_tensor(base, "base", ndim=1)
    if base.shape[0] != pos.WIDTH:
        raise ValueError(f"base: expected {pos.WIDTH} words, got "
                         f"{base.shape[0]}")
    if not (0 <= word < pos.WIDTH and 0 <= bits <= 64
            and 0 <= start <= limit <= POW_LIMIT):
        raise ValueError(f"pow grind: word {word}, bits {bits}, start "
                         f"{start}, limit {limit} out of range")


def pow_grind(base: torch.Tensor, word: int, bits: int, start: int = 0,
              limit: int = POW_LIMIT, batch: int = POW_BATCH) -> int:
    """Plain version of K8: the smallest w in [start, limit) whose response
    (word 7 of the permutation of `base` with w at word `word`) is below
    2^(64 - bits), through batches of `batch` candidates on
    poseidon_fast_t; RuntimeError if none."""
    _check_grind(base, word, bits, start, limit)
    if bits == 0 and start < limit:      # every candidate passes
        return start
    bound = torch.tensor(gf.as_i64(1 << (64 - bits)), dtype=torch.int64,
                         device=base.device)
    for s in range(start, limit, batch):
        n = min(batch, limit - s)
        states = base[:, None].repeat(1, n)
        states[word] = torch.arange(s, s + n, dtype=torch.int64,
                                   device=base.device)
        response = pos.poseidon_fast_t(states)[pos.SPONGE_RATE - 1]
        hit = torch.nonzero(gf.ult(response, bound))
        if hit.numel():
            return s + int(hit[0, 0])
    raise RuntimeError(f"proof-of-work search found no witness in "
                       f"[{start}, {limit})")


def pow_grind_cuda(base: torch.Tensor, word: int, bits: int, start: int = 0,
                   limit: int = POW_LIMIT) -> int:
    """K8: ``pow_grind`` in one launch; only the 12 words go up and the
    witness comes down."""
    _check_grind(base, word, bits, start, limit)
    if kernels.on_cpu(base):
        return pow_grind(base, word, bits, start, limit)
    kernels.check_kernel_operand(base, "base", base.device)
    buf = torch.cat([base, torch.tensor([-1, 0], dtype=torch.int64,
                                        device=base.device)])
    kernels.call("plk_pow_grind", buf.data_ptr(), word, bits, start, limit,
                 base.device.index, kernels.stream_of(base))
    pow_grind_cuda.launches += 1
    witness = int(buf[pos.WIDTH]) & _NONE
    if witness == _NONE:
        raise RuntimeError(f"proof-of-work search found no witness in "
                           f"[{start}, {limit})")
    return witness


pow_grind_cuda.launches = 0
