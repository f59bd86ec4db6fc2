"""Poseidon-12 over Goldilocks: constants and the plain torch versions.

The port's counterpart of plonky2_tpu/hash/poseidon.py (constants, scalar
permutation), hash/poseidon_jax.py (``poseidon_t``, ``hash_leaves_cols``,
``compress_pairs_cols``, in the same (12, B) column layout) and
hash/poseidon_wires_jax.py (``poseidon_fast_t``), plus the numpy batch
permutation ``poseidon`` and the sponges ``hash_n_to_m_no_pad`` and
``hash_no_pad`` (JAX hash/poseidon.py), which the public-inputs hash runs
on the host.  Width 12, 4 + 22 + 4 rounds, x^7 S-box, circulant +
diagonal MDS.  ``poseidon_t`` runs the naive round schedule,
``poseidon_fast_t`` the fast partial-round one that kernels K1, K2, K7 and
K8 run (hash/poseidon_cuda.py); both give the same permutation.
``hash_leaves_cols`` and ``compress_pairs_cols`` are the plain versions of
K1 and K2.

The round constants and the fast schedule's tables are the port's copies
of plonky2_tpu/hash/poseidon_round_constants.npy and
poseidon_fast_constants.npz.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..field import gf
from ..field.convert import from_u64
from ..field import goldilocks as gl
from ..field.goldilocks import P

WIDTH = 12
SPONGE_RATE = 8
HALF_N_FULL_ROUNDS = 4
N_PARTIAL_ROUNDS = 22
N_ROUNDS = 2 * HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS  # 30

MDS_CIRC = np.array([17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20],
                    dtype=np.uint64)
MDS_DIAG = np.array([8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], dtype=np.uint64)

ROUND_CONSTANTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "poseidon_round_constants.npy")
ALL_ROUND_CONSTANTS = np.load(ROUND_CONSTANTS_PATH)
if ALL_ROUND_CONSTANTS.shape != (WIDTH * N_ROUNDS,):
    raise ValueError(f"bad round constants {ALL_ROUND_CONSTANTS.shape}")

# M[r, c] = CIRC[(c - r) mod 12] + (r == c) * DIAG[r]
_idx = (np.arange(WIDTH)[None, :] - np.arange(WIDTH)[:, None]) % WIDTH
MDS_MATRIX = MDS_CIRC[_idx] + np.diag(MDS_DIAG)

# The fast partial-round schedule (plonky2 poseidon.rs, mds_partial_layer_
# init/_fast): after the first 4 full rounds add FIRST_ROUND_CONSTANT, apply
# the 11x11 INITIAL_MATRIX to s[1:], then run 22 rounds of an S-box on s[0],
# ROUND_CONSTANTS[r] (none in the last round), s[0] <- MS0 s0 + W_HATS[r] .
# s[1:] and s[1:] += s0 VS[r].
FAST_CONSTANTS_PATH = os.path.join(os.path.dirname(ROUND_CONSTANTS_PATH),
                                   "poseidon_fast_constants.npz")
with np.load(FAST_CONSTANTS_PATH) as _fast:
    FAST_PARTIAL_ROUND_CONSTANTS = _fast["fast_partial_round_constants"]
    FAST_PARTIAL_FIRST_ROUND_CONSTANT = _fast[
        "fast_partial_first_round_constant"]
    FAST_PARTIAL_ROUND_VS = _fast["fast_partial_round_vs"]
    FAST_PARTIAL_ROUND_W_HATS = _fast["fast_partial_round_w_hats"]
    FAST_PARTIAL_ROUND_INITIAL_MATRIX = _fast[
        "fast_partial_round_initial_matrix"]
FAST_MS0 = int(MDS_CIRC[0] + MDS_DIAG[0])


def fast_round_constants_after_sbox() -> np.ndarray:
    """(22,) the constant added after partial round r's S-box: 0 in the
    last round."""
    prc = np.zeros(N_PARTIAL_ROUNDS, dtype=np.uint64)
    prc[:-1] = FAST_PARTIAL_ROUND_CONSTANTS[:N_PARTIAL_ROUNDS - 1]
    return prc


def is_full_round(r: int) -> bool:
    return r < HALF_N_FULL_ROUNDS or r >= HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    rc = from_u64(ALL_ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH, 1), device)
    mds = torch.from_numpy(MDS_MATRIX.astype(np.float64)).to(device)
    return rc, mds


def _sbox(x):
    x2 = gf.mul(x, x)
    x3 = gf.mul(x2, x)
    x4 = gf.mul(x2, x2)
    return gf.mul(x3, x4)


def _mds(state, mds):
    """out[r] = sum_c M[r, c] * state[c] mod p, exact through 32-bit
    halves: `mds` is M in float64, and with coefficients < 64 each
    half-sum stays under 2^42, so a float64 product sums it exactly."""
    acc_lo = (mds @ (state & gf.M32).to(torch.float64)).to(torch.int64)
    acc_hi = (mds @ gf.srl(state, 32).to(torch.float64)).to(torch.int64)
    low = acc_lo + ((acc_hi & gf.M32) << 32)
    high = gf.srl(acc_hi, 32) + gf.ult(low, acc_lo).to(torch.int64)
    return gf.reduce128(low, high)


def poseidon_t(state: torch.Tensor) -> torch.Tensor:
    """Permutation on a (12, B) int64 state, canonical in and out."""
    rc, mds = _tables(str(state.device))
    for r in range(N_ROUNDS):
        state = gf.add(state, rc[r])
        if is_full_round(r):
            state = _sbox(state)
        else:
            state = torch.cat([_sbox(state[:1]), state[1:]])
        state = _mds(state, mds)
    return state


@functools.lru_cache(maxsize=None)
def _fast_tables(device: str):
    t = lambda a, *shape: from_u64(np.ascontiguousarray(  # noqa: E731
        a).reshape(*a.shape, *shape), device)
    return (t(FAST_PARTIAL_FIRST_ROUND_CONSTANT, 1),
            t(FAST_PARTIAL_ROUND_INITIAL_MATRIX, 1),
            t(fast_round_constants_after_sbox()),
            t(FAST_PARTIAL_ROUND_W_HATS, 1), t(FAST_PARTIAL_ROUND_VS, 1))


def _sum_rows(x):
    """Modular sum over axis 0."""
    acc = x[0]
    for row in x[1:]:
        acc = gf.add(acc, row)
    return acc


def poseidon_fast_t(state: torch.Tensor) -> torch.Tensor:
    """The permutation on a (12, B) int64 state on the fast partial-round
    schedule, canonical in and out; equal to ``poseidon_t``."""
    rc, mds = _tables(str(state.device))
    first, init, prc, w_hats, vs = _fast_tables(str(state.device))

    def full_round(st, r):
        return _mds(_sbox(gf.add_nc(st, rc[r])), mds)

    for r in range(HALF_N_FULL_ROUNDS):
        state = full_round(state, r)
    state = gf.add_nc(state, first)
    # new[c] = sum_r init[r - 1][c - 1] * state[r] for c >= 1
    rest = _sum_rows(gf.mul(state[1:, None], init))
    s0 = state[0]
    for r in range(N_PARTIAL_ROUNDS):
        x0 = gf.add(_sbox(s0), prc[r])
        s0 = gf.add(gf.mul(x0, FAST_MS0), _sum_rows(gf.mul(rest, w_hats[r])))
        rest = gf.add(rest, gf.mul(x0[None], vs[r]))
    state = torch.cat([s0[None], rest])
    for r in range(HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS, N_ROUNDS):
        state = full_round(state, r)
    return state


def hash_leaves_cols(leaves: torch.Tensor) -> torch.Tensor:
    """Column-major overwrite-mode sponge: leaves (L, B) -> digests (4, B).
    Rate-8 blocks overwrite state rows [0, 8); a last partial block of w
    rows overwrites rows [0, w)."""
    L, B = leaves.shape
    state = torch.zeros((WIDTH, B), dtype=torch.int64, device=leaves.device)
    for start in range(0, L, SPONGE_RATE):
        chunk = leaves[start:start + SPONGE_RATE]
        state = poseidon_t(torch.cat([chunk, state[chunk.shape[0]:]]))
    return state[:4]


def compress_pairs_cols(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Two-to-one compression: (4, B), (4, B) -> (4, B)."""
    return poseidon_t(torch.cat([x, y, torch.zeros_like(x)]))[:4]


# -- scalar path (python ints) for host-side Merkle proof checks -----------

_RC_INT = [[int(c) for c in ALL_ROUND_CONSTANTS[r * WIDTH:(r + 1) * WIDTH]]
           for r in range(N_ROUNDS)]
_MDS_INT = [[int(m) for m in row] for row in MDS_MATRIX]


def _sbox_int(x: int) -> int:
    x2 = x * x % P
    return x2 * x2 % P * (x2 * x % P) % P


_FAST_INT = None


def _fast_ints():
    global _FAST_INT
    if _FAST_INT is None:
        ints = lambda a: [int(x) for x in a]  # noqa: E731
        _FAST_INT = (ints(FAST_PARTIAL_FIRST_ROUND_CONSTANT),
                     [ints(r) for r in FAST_PARTIAL_ROUND_INITIAL_MATRIX],
                     ints(fast_round_constants_after_sbox()),
                     [ints(r) for r in FAST_PARTIAL_ROUND_W_HATS],
                     [ints(r) for r in FAST_PARTIAL_ROUND_VS])
    return _FAST_INT


def permute_ints(state) -> list:
    """The permutation on 12 python ints, on the fast partial-round
    schedule (the host challenger's and the Merkle checks' permutation;
    equal to poseidon_t)."""
    first, init, prc, w_hats, vs = _fast_ints()

    def full_round(s, r):
        s = [_sbox_int((x + c) % P) for x, c in zip(s, _RC_INT[r])]
        return [sum(m * x for m, x in zip(row, s)) % P for row in _MDS_INT]

    s = [int(x) % P for x in state]
    for r in range(HALF_N_FULL_ROUNDS):
        s = full_round(s, r)
    s = [(x + c) % P for x, c in zip(s, first)]
    rest = [sum(init[r][c] * s[r + 1] for r in range(WIDTH - 1)) % P
            for c in range(WIDTH - 1)]
    s0 = s[0]
    for r in range(N_PARTIAL_ROUNDS):
        x0 = (_sbox_int(s0) + prc[r]) % P
        s0 = (FAST_MS0 * x0 + sum(w * x for w, x in zip(w_hats[r], rest))) % P
        rest = [(x + x0 * v) % P for x, v in zip(rest, vs[r])]
    s = [s0] + rest
    for r in range(HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS, N_ROUNDS):
        s = full_round(s, r)
    return s


def hash_or_noop_ints(leaf) -> list:
    """Leaf digest: <= 4 elements pass through zero-padded, longer leaves
    go through the overwrite sponge."""
    leaf = [int(x) for x in leaf]
    if len(leaf) <= 4:
        return leaf + [0] * (4 - len(leaf))
    state = [0] * WIDTH
    for start in range(0, len(leaf), SPONGE_RATE):
        chunk = leaf[start:start + SPONGE_RATE]
        state = permute_ints(chunk + state[len(chunk):])
    return state[:4]


def compress_ints(left, right) -> list:
    return permute_ints(list(left) + list(right) + [0] * 4)[:4]


# -- batch path (numpy uint64) for the host sponge and the proof of work ----


def _sbox_np(x: np.ndarray) -> np.ndarray:
    x2 = gl.mul(x, x)
    return gl.mul(gl.mul(x2, x), gl.mul(x2, x2))


def _mds_np(state: np.ndarray) -> np.ndarray:
    """acc[r] = sum_c M[r, c] * state[c], exact through 32-bit halves."""
    acc_lo = (state & np.uint64(0xFFFFFFFF)) @ MDS_MATRIX.T
    acc_hi = (state >> np.uint64(32)) @ MDS_MATRIX.T
    with np.errstate(over="ignore"):
        low = acc_lo + ((acc_hi & np.uint64(0xFFFFFFFF)) << np.uint64(32))
    high = (acc_hi >> np.uint64(32)) + (low < acc_lo).astype(np.uint64)
    return gl.reduce128(low, high)


def poseidon(state: np.ndarray) -> np.ndarray:
    """The permutation on states (..., 12) of canonical numpy uint64."""
    state = np.asarray(state, dtype=np.uint64)
    if state.shape[-1] != WIDTH:
        raise ValueError(f"state: expected (..., {WIDTH}), got {state.shape}")
    for r in range(N_ROUNDS):
        state = gl.add(state, ALL_ROUND_CONSTANTS[r * WIDTH:(r + 1) * WIDTH])
        if is_full_round(r):
            state = _sbox_np(state)
        else:
            state = np.concatenate([_sbox_np(state[..., :1]),
                                    state[..., 1:]], axis=-1)
        state = _mds_np(state)
    return state


def hash_n_to_m_no_pad(inputs, num_outputs: int) -> np.ndarray:
    """Overwrite-mode sponge of a 1-D input, squeezed to num_outputs."""
    inputs = np.asarray(inputs, dtype=np.uint64).reshape(-1)
    state = np.zeros(WIDTH, dtype=np.uint64)
    for start in range(0, len(inputs), SPONGE_RATE):
        chunk = inputs[start:start + SPONGE_RATE]
        state[:len(chunk)] = chunk
        state = poseidon(state)
    outputs = []
    while True:
        for i in range(SPONGE_RATE):
            outputs.append(state[i])
            if len(outputs) == num_outputs:
                return np.array(outputs, dtype=np.uint64)
        state = poseidon(state)


def hash_no_pad(inputs) -> np.ndarray:
    """The 4-element digest of a 1-D input (the public-inputs hash)."""
    return hash_n_to_m_no_pad(inputs, 4)
