"""Poseidon-12 over Goldilocks: constants and the plain torch versions.

The port's counterpart of plonky2_tpu/hash/poseidon.py (constants, scalar
permutation) and hash/poseidon_jax.py (``poseidon_t``, ``hash_leaves_cols``,
``compress_pairs_cols``, in the same (12, B) column layout).  Width 12,
4 + 22 + 4 rounds, x^7 S-box, circulant + diagonal MDS, the naive round
schedule.  ``hash_leaves_cols`` and ``compress_pairs_cols`` are the plain
versions of kernels K1 and K2 (hash/poseidon_cuda.py).

The round constants are the port's copy of
plonky2_tpu/hash/poseidon_round_constants.npy.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..field import gf
from ..field.convert import from_u64
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


def is_full_round(r: int) -> bool:
    return r < HALF_N_FULL_ROUNDS or r >= HALF_N_FULL_ROUNDS + N_PARTIAL_ROUNDS


@functools.lru_cache(maxsize=None)
def _tables(device: str):
    rc = from_u64(ALL_ROUND_CONSTANTS.reshape(N_ROUNDS, WIDTH, 1), device)
    mds = torch.from_numpy(MDS_MATRIX.astype(np.int64)).to(device)
    return rc, mds[:, :, None]


def _sbox(x):
    x2 = gf.mul(x, x)
    x3 = gf.mul(x2, x)
    x4 = gf.mul(x2, x2)
    return gf.mul(x3, x4)


def _mds(state, mds):
    """out[r] = sum_c M[r, c] * state[c] mod p, exact through 32-bit
    halves (coefficients < 64, so each half-sum stays under 2^42)."""
    acc_lo = (mds * (state & gf.M32)[None]).sum(1)
    acc_hi = (mds * gf.srl(state, 32)[None]).sum(1)
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


def permute_ints(state) -> list:
    """The permutation on 12 python ints (same schedule as poseidon_t)."""
    s = [int(x) % P for x in state]
    for r in range(N_ROUNDS):
        s = [(x + c) % P for x, c in zip(s, _RC_INT[r])]
        if is_full_round(r):
            s = [_sbox_int(x) for x in s]
        else:
            s[0] = _sbox_int(s[0])
        s = [sum(m * x for m, x in zip(row, s)) % P for row in _MDS_INT]
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
