"""Wrappers for kernels K1 (leaf sponge), K2 (Merkle levels), K7 (the
Poseidon gate's witness waves), K8 (the FRI proof-of-work grind) and K9
(the transcript's duplex sponge).

K1 replaces plonky2_tpu/hash/poseidon_pallas.py:hash_leaves_cols_pallas and
K2 replaces poseidon_pallas.py:compress_pairs_cols_pallas, in two forms: one
launch a wide level (``compress_level_cuda``) and one launch for the narrow
top of a tree (``compress_tail_cuda``).  Their CUDA source is
csrc/poseidon.cu, whose notes give the bounds on an H100 (integer operations
for K1 and a wide level, the latency of one permutation a level for the
narrow top) and the designs.  Each wrapper takes the plain version beside it
(hash/poseidon.py) for a CPU tensor only; a CUDA tensor launches the kernel
or the call raises.  ``<wrapper>.launches`` counts kernel launches.

K7, K8 and K9 have no TPU kernel to replace: the JAX package computes a
wave in XLA (plonky2_tpu/hash/poseidon_wires_jax.py:poseidon_wire_batch),
and grinds and runs its transcript's sponge in XLA inside its fused FRI
(plonky2_tpu/fri/device_prover.py:_fused_fri_fn,
plonky2_tpu/iop/challenger_jax.py:DeviceChallenger).  K7's plain version
is hash/poseidon_wires.py:poseidon_wires_waves, K8's ``pow_grind`` and
K9's ``sponge`` below.  K8 has two wrappers: ``pow_grind_sponge_cuda``
grinds from K9's buffer and leaves the witness in it (the fused FRI), and
``pow_grind_cuda`` from 12 words the host made (the layered FRI).
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from ..field import gf
from ..field import gf2
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


@functools.lru_cache(maxsize=None)
def grind_scratch(device: torch.device) -> torch.Tensor:
    """K8's scratch on `device`, made once (no upload): [0] the smallest
    pass, which each launch leaves at 2^64 - 1; then the last launch's
    record, [1] its entry and [2] its exit (ns of the card's clock), [3]
    its rounds and [4] its answer."""
    scratch = torch.zeros(5, dtype=torch.int64, device=device)
    scratch[0:1].fill_(-1)
    return scratch


def _launch_grind(state, inputs, n_in: int, word: int, bits: int,
                  start: int, limit: int, out, slot) -> None:
    dev = state.device
    kernels.call("plk_pow_grind", state.data_ptr(), inputs, n_in, word,
                 bits, start, limit, grind_scratch(dev).data_ptr(),
                 out.data_ptr(), slot, dev.index, kernels.stream_of(state))


def pow_grind_cuda(base: torch.Tensor, word: int, bits: int, start: int = 0,
                   limit: int = POW_LIMIT) -> int:
    """K8 from a host-made state: ``pow_grind`` in one launch on the 12
    words of `base`; the witness comes down (the layered FRI's form)."""
    _check_grind(base, word, bits, start, limit)
    if kernels.on_cpu(base):
        return pow_grind(base, word, bits, start, limit)
    kernels.check_kernel_operand(base, "base", base.device)
    out = torch.full((1,), -1, dtype=torch.int64, device=base.device)
    _launch_grind(base, base.data_ptr(), 0, word, bits, start, limit, out,
                  None)
    pow_grind_cuda.launches += 1
    witness = int(out[0]) & _NONE
    if witness == _NONE:
        raise RuntimeError(f"proof-of-work search found no witness in "
                           f"[{start}, {limit})")
    return witness


pow_grind_cuda.launches = 0


def _check_sponge_buf(buf, n_in: int, limit: int) -> None:
    kernels.check_field_tensor(buf, "buf", ndim=1)
    if buf.shape[0] != SPONGE_WORDS:
        raise ValueError(f"buf: expected {SPONGE_WORDS} words, got "
                         f"{buf.shape[0]}")
    if not 0 <= n_in <= limit:
        raise ValueError(f"n_in {n_in} outside [0, {limit}]")


def duplex_input(buf: torch.Tensor, n_in: int) -> torch.Tensor:
    """The 12 words the sponge in `buf` permutes next: its n_in pending
    inputs over its state's first words."""
    return torch.cat([buf[pos.WIDTH:pos.WIDTH + n_in], buf[n_in:pos.WIDTH]])


def pow_grind_sponge_cuda(buf: torch.Tensor, n_in: int, bits: int,
                          start: int = 0,
                          limit: int = POW_LIMIT) -> torch.Tensor:
    """K8 on the transcript's sponge (K9's buffer, n_in < 8 inputs
    pending): the smallest witness for its duplex input state, candidates
    at word n_in, written into pending slot n_in and into the (1,) tensor
    returned.  Nothing crosses to the host; 2^64 - 1 where no witness lies
    in [start, limit)."""
    _check_sponge_buf(buf, n_in, pos.SPONGE_RATE - 1)
    _check_grind(buf[:pos.WIDTH], n_in, bits, start, limit)
    if kernels.on_cpu(buf):
        try:
            w = pow_grind(duplex_input(buf, n_in), n_in, bits, start, limit)
        except RuntimeError:
            w = _NONE
        buf[pos.WIDTH + n_in] = gf.as_i64(w)
        return buf[pos.WIDTH + n_in:pos.WIDTH + n_in + 1].clone()
    kernels.check_kernel_operand(buf, "buf", buf.device)
    out = torch.empty(1, dtype=torch.int64, device=buf.device)
    inputs = buf.data_ptr() + 8 * pos.WIDTH
    _launch_grind(buf, inputs, n_in, n_in, bits, start, limit, out,
                  inputs + 8 * n_in)
    pow_grind_sponge_cuda.launches += 1
    return out


pow_grind_sponge_cuda.launches = 0

# K9: the transcript sponge's buffer, the 12 state words and 8 pending
# inputs (its outputs are the state's first words)
SPONGE_WORDS = pos.WIDTH + pos.SPONGE_RATE


def sponge_lengths(n_in: int, n_out: int, n_words: int,
                   n_draws: int) -> tuple:
    """(n_in, n_out, permutations) of a sponge with n_in inputs pending and
    n_out outputs left after K9 absorbs n_words words and draws n_draws
    (the host challenger's buffering, iop/challenger.py; n_in = 8 means a
    kernel filled the last pending slot: duplex first)."""
    rate = pos.SPONGE_RATE
    perms = 0
    if n_in == rate:
        n_in, n_out, perms = 0, rate, 1
    if n_words:
        total = n_in + n_words
        perms += total // rate
        n_in = total % rate
        n_out = rate if n_in == 0 else 0
    for _ in range(n_draws):
        if n_in or not n_out:
            n_in, n_out, perms = 0, rate, perms + 1
        n_out -= 1
    return n_in, n_out, perms


def _check_sponge(buf, n_in, n_out, src, n_draws, index_mask, arity):
    _check_sponge_buf(buf, n_in, pos.SPONGE_RATE)
    if src is not None:
        kernels.check_field_tensor(src, "src", ndim=2)
        if not 1 <= src.shape[0] <= 4 or (src.numel()
                                           and src.stride(1) != 1):
            raise ValueError(f"src: expected (rows, cols) with 1-4 rows "
                             f"of consecutive words, got "
                             f"{tuple(src.shape)} strides {src.stride()}")
    if not (0 <= n_out <= pos.SPONGE_RATE and n_draws >= 0
            and 0 <= index_mask < 1 << 63 and arity >= 0
            and (arity == 0 or n_draws >= 2)):
        raise ValueError(f"sponge: n_out {n_out}, n_draws {n_draws}, "
                         f"index_mask {index_mask}, arity {arity}")


def sponge(buf: torch.Tensor, n_in: int, n_out: int, src=None,
           n_draws: int = 0, index_mask: int = 0, arity: int = 0):
    """Plain version of K9, on poseidon_fast_t: the sponge in `buf` (state,
    pending inputs; n_in pending, its first n_out state words its outputs)
    absorbs the words of src (rows, cols) column by column, then draws
    n_draws words; `buf` is updated in place.  Returns (draws (n_draws,),
    draws & index_mask where index_mask else None, the powers beta^0 ..
    beta^(arity - 1) of beta = (draws[0], draws[1]) as (2, arity) where
    arity else None)."""
    _check_sponge(buf, n_in, n_out, src, n_draws, index_mask, arity)
    rate = pos.SPONGE_RATE
    words = src.T.reshape(-1) if src is not None else buf[:0]
    state = buf[:pos.WIDTH].clone()
    pending = buf[pos.WIDTH:].clone()

    def duplex(n):
        s = torch.cat([pending[:n], state[n:]])
        return pos.poseidon_fast_t(s[:, None])[:, 0], 0, rate

    if n_in == rate:
        state, n_in, n_out = duplex(n_in)
    k = 0
    while k < words.shape[0]:
        take = min(rate - n_in, words.shape[0] - k)
        pending[n_in:n_in + take] = words[k:k + take]
        n_in, n_out, k = n_in + take, 0, k + take
        if n_in == rate:
            state, n_in, n_out = duplex(n_in)
    draws = []
    for _ in range(n_draws):
        if n_in or not n_out:
            state, n_in, n_out = duplex(n_in)
        n_out -= 1
        draws.append(state[n_out])
    buf[:pos.WIDTH] = state
    buf[pos.WIDTH:pos.WIDTH + n_in] = pending[:n_in]
    draws = torch.stack(draws) if draws else buf[:0].clone()
    powers = None
    if arity:
        beta = (draws[0], draws[1])
        p = [(torch.ones_like(draws[0]), torch.zeros_like(draws[0]))]
        for _ in range(1, arity):
            p.append(gf2.mul2(p[-1], beta))
        powers = torch.stack([torch.stack([c[0] for c in p]),
                              torch.stack([c[1] for c in p])])
    return draws, (draws & index_mask if index_mask else None), powers


def sponge_cuda(buf: torch.Tensor, n_in: int, n_out: int, src=None,
                n_draws: int = 0, index_mask: int = 0, arity: int = 0):
    """K9: ``sponge`` in one launch; the results are written on the card
    and nothing crosses to the host."""
    _check_sponge(buf, n_in, n_out, src, n_draws, index_mask, arity)
    if kernels.on_cpu(buf):
        return sponge(buf, n_in, n_out, src, n_draws, index_mask, arity)
    dev = buf.device
    kernels.check_kernel_operand(buf, "buf", dev)
    if src is not None and src.device != dev:
        raise ValueError(f"src: on {src.device}, expected {dev}")
    out = torch.empty(n_draws * (2 if index_mask else 1) + 2 * arity,
                      dtype=torch.int64, device=dev)
    draws = out[:n_draws]
    idx = out[n_draws:2 * n_draws] if index_mask else None
    powers = out[out.shape[0] - 2 * arity:].view(2, arity) if arity else None
    rows, cols = (src.shape if src is not None else (1, 0))
    kernels.call("plk_sponge", buf.data_ptr(),
                 kernels.ptr(src) if cols else None, rows,
                 src.stride(0) if cols else 0, cols, n_in, n_out,
                 draws.data_ptr(), n_draws, kernels.ptr(idx), index_mask,
                 kernels.ptr(powers), arity, dev.index,
                 kernels.stream_of(buf))
    sponge_cuda.launches += 1
    return draws, idx, powers


sponge_cuda.launches = 0
