"""The port's plain Poseidon (the plain versions of kernels K1 and K2) and its
Merkle levels against the JAX package: poseidon_jax (which the JAX package's
own tests hold bit-identical to the Pallas kernels), the numpy oracle and
merkle_jax.  Exact equality.  Also a numpy model of the lane-split
permutation that K2's narrow-top kernel runs (csrc/poseidon.cu:
permute_lanes), held against the scalar permutation."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_tpu.field import gf_jax as gfj
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.hash import merkle_jax as mkj
from plonky2_tpu.hash import poseidon as jpos
from plonky2_tpu.hash import poseidon_jax as pj
from plonky2_tpu.hash import poseidon_wires_jax as pwj
from plonky2_tpu.hash.hashers import POSEIDON_CONFIG
from plonky2_tpu_torch.field import convert
from plonky2_tpu_torch.hash import merkle_torch
from plonky2_tpu_torch.hash import poseidon as tpos
from plonky2_tpu_torch.hash import poseidon_cuda as pc

P = jgl.P


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _jax_pair(u):
    lo, hi = gfj.from_u64(u)
    return jnp.asarray(lo), jnp.asarray(hi)


def _from_jax(pair):
    return gfj.to_u64((np.asarray(pair[0]), np.asarray(pair[1])))


def test_constants_copied_byte_for_byte():
    here = os.path.dirname(jpos.__file__)
    with open(os.path.join(here, "poseidon_round_constants.npy"), "rb") as f:
        want = f.read()
    with open(tpos.ROUND_CONSTANTS_PATH, "rb") as f:
        assert f.read() == want
    np.testing.assert_array_equal(tpos.MDS_CIRC, jpos.MDS_CIRC)
    np.testing.assert_array_equal(tpos.MDS_DIAG, jpos.MDS_DIAG)
    np.testing.assert_array_equal(tpos.MDS_MATRIX, jpos.MDS_MATRIX)
    assert (tpos.N_ROUNDS, tpos.N_PARTIAL_ROUNDS) == (jpos.N_ROUNDS,
                                                      jpos.N_PARTIAL_ROUNDS)


def test_permutation_matches_poseidon_jax_and_oracle():
    st = _rand((12, 64), 1)
    st[:, 0] = 0
    st[:, 1] = P - 1
    got = convert.to_u64(tpos.poseidon_t(convert.from_u64(st)))
    np.testing.assert_array_equal(got, _from_jax(pj.poseidon_t(_jax_pair(st))))
    np.testing.assert_array_equal(got, jpos.poseidon(st.T).T)


def test_fast_constants_copied_byte_for_byte():
    here = os.path.dirname(jpos.__file__)
    with open(os.path.join(here, "poseidon_fast_constants.npz"), "rb") as f:
        want = f.read()
    with open(tpos.FAST_CONSTANTS_PATH, "rb") as f:
        assert f.read() == want


BOUNDARY = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - 1], dtype=np.uint64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_poseidon_fast_t_matches_jax_and_poseidon_t(seed):
    """The fast partial-round schedule (the one kernels K1 and K2 run)
    against the JAX package's poseidon_fast_t and the port's naive
    poseidon_t, on random states and states of boundary values."""
    rng = np.random.default_rng(seed)
    st = _rand((12, 96), 30 + seed)
    st[:, :48] = BOUNDARY[rng.integers(0, 5, size=(12, 48))]
    st[:, 48:53] = BOUNDARY[None, :]           # each value in every word
    t = convert.from_u64(st)
    got = convert.to_u64(tpos.poseidon_fast_t(t))
    np.testing.assert_array_equal(
        got, _from_jax(pwj.poseidon_fast_t(_jax_pair(st))))
    np.testing.assert_array_equal(got, convert.to_u64(tpos.poseidon_t(t)))
    assert tpos.permute_ints(st[:, 7]) == [int(x) for x in got[:, 7]]


def test_scalar_permutation_matches_oracle():
    st = _rand((12,), 2)
    assert tpos.permute_ints(st) == jpos.poseidon_ints([int(x) for x in st])
    assert tpos.permute_ints([0] * 12) == jpos.poseidon_ints([0] * 12)


@pytest.mark.parametrize("L", [5, 8, 19, 234])
def test_hash_leaves_cols_matches_poseidon_jax(L):
    leaves = _rand((L, 32), 10 + L)
    t = convert.from_u64(leaves)
    got = convert.to_u64(tpos.hash_leaves_cols(t))
    np.testing.assert_array_equal(
        got, _from_jax(pj.hash_leaves_cols(_jax_pair(leaves))))
    # the K1 wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(convert.to_u64(pc.hash_leaves_cols_cuda(t)),
                                  got)
    assert tpos.hash_or_noop_ints(leaves[:, 3]) == [int(x) for x in got[:, 3]]


def test_compress_pairs_cols_matches_poseidon_jax():
    x, y = _rand((4, 64), 3), _rand((4, 64), 4)
    got = convert.to_u64(tpos.compress_pairs_cols(convert.from_u64(x),
                                                  convert.from_u64(y)))
    np.testing.assert_array_equal(
        got, _from_jax(pj.compress_pairs_cols(_jax_pair(x), _jax_pair(y))))
    assert tpos.compress_ints(x[:, 5], y[:, 5]) == [int(v) for v in got[:, 5]]
    # K2's plain version pairs adjacent columns of one level
    level = np.stack([x, y], axis=2).reshape(4, 128)
    np.testing.assert_array_equal(
        convert.to_u64(pc.compress_level_cuda(convert.from_u64(level))), got)


@pytest.mark.parametrize("L", [3, 4, 12])
def test_digest_levels_match_merkle_jax(L):
    leaves = _rand((L, 64), 20 + L)
    got = merkle_torch.build_digest_levels(convert.from_u64(leaves), 2)
    want = mkj.build_digest_levels(_jax_pair(leaves), 2)
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        np.testing.assert_array_equal(convert.to_u64(a), _from_jax(b))
    host = POSEIDON_CONFIG.hash_leaves(leaves.T)
    np.testing.assert_array_equal(convert.to_u64(got[0]).T, host)


@pytest.mark.parametrize("L", [4, 12])
@pytest.mark.parametrize("log_n", range(5, 12))
def test_compress_tail_and_digest_levels_match_merkle_jax(log_n, L,
                                                          monkeypatch):
    """K2's narrow top (its plain version, which the wrapper takes for a CPU
    tensor) and build_digest_levels against merkle_jax at every cap height,
    with boundary words in the leaves; build_digest_levels at odd cap
    heights with the tail threshold lowered, so that wide levels come
    first.  merkle_jax's
    levels at cap height h are the first log_n - h + 1 of its levels at
    cap height 0 (checked at one h)."""
    n = 1 << log_n
    rng = np.random.default_rng(40 + log_n + L)
    leaves = _rand((L, n), 50 + log_n + L)
    leaves[:, :n // 4] = BOUNDARY[rng.integers(0, 5, size=(L, n // 4))]
    t = convert.from_u64(leaves)
    digests = merkle_torch.hash_leaves_or_noop_cols(t)
    all_levels = [_from_jax(b) for b in mkj.build_digest_levels(
        _jax_pair(leaves), 0)]
    mid = [_from_jax(b) for b in mkj.build_digest_levels(
        _jax_pair(leaves), log_n // 2)]
    assert len(mid) == log_n - log_n // 2 + 1
    for a, b in zip(mid, all_levels):
        np.testing.assert_array_equal(a, b)
    for cap in range(log_n + 1):
        want = all_levels[:log_n - cap + 1]
        if cap < log_n:
            tail = pc.compress_tail_cuda(digests, log_n - cap)
            assert [tuple(x.shape) for x in tail] == [w.shape
                                                      for w in want[1:]]
            for a, b in zip(tail, want[1:]):
                np.testing.assert_array_equal(convert.to_u64(a), b)
        if cap % 2:
            monkeypatch.setattr(merkle_torch, "TAIL_PARENTS", 4)
        got = merkle_torch.build_digest_levels(t, cap)
        monkeypatch.undo()
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(convert.to_u64(a), b)


# -- a numpy model of the lane-split permutation (csrc/poseidon.cu) ---------
# Lanes are an array axis, a shuffle is a gather along it, and every
# operation is the kernel's on wrapping uint64: the products' 128-bit
# halves (gl::mul_wide; mul_wide_split gives the same halves), the
# 128-bit reduction (gl::reduce128; reduce128_cc computes the same
# representative), and the 160-bit Dot sums as five 32-bit limbs added with
# carries, the top limb wrapping as addc.u32 does.

_M32 = np.uint64(0xFFFFFFFF)
_EPS = _M32


def _mul_wide(a, b):
    a0, a1, b0, b1 = a & _M32, a >> 32, b & _M32, b >> 32
    t = a0 * b0
    u = a0 * b1 + (t >> 32)
    v = a1 * b0 + (u & _M32)
    w = a1 * b1 + (u >> 32)
    return (t & _M32) | (v << 32), w + (v >> 32)


def _reduce128(lo, hi):
    hh, hl = hi >> 32, hi & _EPS
    t0 = lo - hh
    t0 = np.where(lo < hh, t0 - _EPS, t0)
    t1 = hl * _EPS
    t2 = t0 + t1
    return np.where(t2 < t1, t2 + _EPS, t2)


def _mul(a, b):
    return _reduce128(*_mul_wide(a, b))


def _sbox(x):
    x2 = _mul(x, x)
    return _mul(_mul(x2, x), _mul(x2, x2))


def _add_nc(a, b):
    s = a + b
    return np.where(s < a, s + _EPS, s)


def _limbs(lo, hi):
    return np.stack([lo & _M32, lo >> 32, hi & _M32, hi >> 32,
                     np.zeros_like(lo)], axis=-1)


def _dot_merge(d, e):
    out, carry = np.empty_like(d), np.zeros_like(d[..., 0])
    for j in range(5):
        s = d[..., j] + e[..., j] + carry
        out[..., j], carry = s & _M32, s >> 32
    return out


def _dot_reduce(d):
    r = _reduce128((d[..., 1] << 32) | d[..., 0], (d[..., 3] << 32) | d[..., 2])
    t = d[..., 4] << 32
    return np.where(r < t, r - t - _EPS, r - t)


def lane_split_permute(states: np.ndarray, G: int, rec=None) -> np.ndarray:
    """(B, 12) uint64 states -> (B, 12) canonical, as permute_lanes<G>
    computes them: slot k of lane l holds word l + G k.  ``rec``, where
    given, sees what the kernel's recorder sees: rec.full(r, lane, word,
    value) for each lane's words after round r's constant layer (r = 0..7:
    full rounds 0-3 and the last four) and rec.partial(r, s0) with every
    lane's s0 (B, G) before partial round r's S-box."""
    pos = tpos
    K = -(-12 // G)
    lane = np.arange(G)
    words = lane[:, None] + G * np.arange(K)[None, :]            # (G, K)
    valid = words < 12
    wc = np.minimum(words, 11)
    B = states.shape[0]
    st = np.where(valid[None], states[:, wc], 0).astype(np.uint64)
    rc = pos.ALL_ROUND_CONSTANTS.reshape(30, 12)
    mds = pos.MDS_MATRIX.astype(np.uint64)
    first = pos.FAST_PARTIAL_FIRST_ROUND_CONSTANT
    init = pos.FAST_PARTIAL_ROUND_INITIAL_MATRIX
    prc = pos.fast_round_constants_after_sbox()
    what, vs = pos.FAST_PARTIAL_ROUND_W_HATS, pos.FAST_PARTIAL_ROUND_VS
    ms0 = np.uint64(pos.FAST_MS0)

    def word(c):          # __shfl_sync(st.s[c / G], c % G, G): every lane
        return np.repeat(st[:, c % G, c // G][:, None], G, axis=1)

    def full_round(r):
        nonlocal st
        x = _add_nc(st, rc[r][wc])
        if rec is not None:
            for lane_, k in zip(*np.nonzero(valid)):
                rec.full(r if r < 4 else r - 22, lane_, words[lane_, k],
                         x[:, lane_, k])
        st = np.where(valid, _sbox(x), st)
        x = [word(c) for c in range(12)]
        for k in range(K):
            w = wc[:, k]
            al = sum(mds[w, c] * (x[c] & _M32) for c in range(12))
            ah = sum(mds[w, c] * (x[c] >> 32) for c in range(12))
            low = al + (ah << 32)
            high = (ah >> 32) + (low < al).astype(np.uint64)
            st[:, :, k] = np.where(valid[:, k], _reduce128(low, high),
                                   st[:, :, k])

    with np.errstate(over="ignore"):
        for r in range(4):
            full_round(r)
        st = np.where(valid, _add_nc(st, first[wc]), st)
        x = [word(c) for c in range(12)]
        rest = valid & (words > 0)
        wr = np.maximum(wc - 1, 0)
        for k in range(K):
            d = np.zeros((B, G, 5), dtype=np.uint64)
            for i in range(1, 12):
                d = _dot_merge(d, _limbs(*_mul_wide(x[i], init[i - 1][wr[:, k]])))
            st[:, :, k] = np.where(rest[:, k], _dot_reduce(d), st[:, :, k])
        s0 = x[0]
        for r in range(22):
            d = np.zeros((B, G, 5), dtype=np.uint64)
            for k in range(K):
                e = _limbs(*_mul_wide(st[:, :, k], what[r][wr[:, k]]))
                d = np.where(rest[:, k, None], _dot_merge(d, e), d)
            o = 1
            while o < G:      # __shfl_xor_sync of the five limbs
                d = _dot_merge(d, d[:, lane ^ o])
                o <<= 1
            if rec is not None:
                rec.partial(r, s0)
            x0 = _add_nc(_sbox(s0), prc[r])
            d = _dot_merge(d, _limbs(*_mul_wide(x0, ms0)))
            for k in range(K):
                lo, hi = _mul_wide(x0, vs[r][wr[:, k]])
                lo = lo + st[:, :, k]
                hi = hi + (lo < st[:, :, k]).astype(np.uint64)
                st[:, :, k] = np.where(rest[:, k], _reduce128(lo, hi),
                                       st[:, :, k])
            s0 = _dot_reduce(d)
        st[:, 0, 0] = s0[:, 0]
        for r in range(26, 30):
            full_round(r)
    out = np.stack([st[:, w % G, w // G] for w in range(12)], axis=1)
    return np.where(out >= np.uint64(P), out - np.uint64(P), out)


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16])
def test_lane_split_model_matches_permute_ints(G):
    """The lane-split schedule, with its 160-bit merges across the group,
    gives the scalar permutation on random states, states of boundary
    values and compression states (words 8-11 zero)."""
    rng = np.random.default_rng(60 + G)
    st = _rand((24, 12), 70 + G)
    st[:8] = BOUNDARY[rng.integers(0, 5, size=(8, 12))]
    st[8] = P - 1
    st[9] = 0
    st[10:16, 8:] = 0
    got = lane_split_permute(st, G)
    for row, want in zip(got, st):
        assert [int(v) for v in row] == tpos.permute_ints(want)


def _canon(x):
    return np.where(x >= np.uint64(P), x - np.uint64(P), x)


class WireRecorder:
    """csrc/poseidon.cu:WireRecorder over the numpy model: each put(wire,
    lane, value) is kept with its writer lane."""

    def __init__(self):
        self.writes = {}

    def put(self, wire, lane, value):
        self.writes.setdefault(int(wire), []).append((int(lane),
                                                      _canon(value)))

    def full(self, r, lane, w, x):
        if r > 0:
            self.put((4 + 12 * (r - 1) if r < 4 else 62 + 12 * (r - 4)) + w,
                     lane, x)

    def partial(self, r, s0):
        self.put(40 + r, 0, s0[:, 0])      # lane 0 of every lane's s0


def lane_split_wires(dep: np.ndarray):
    """K7's row (poseidon_waves_kernel) over 4 lanes, in numpy: (B, 13)
    inputs and swap wire -> the recorder's writes, wire -> [(lane, (B,)
    values)].  Lane l holds words l, l + 4 and l + 8: it computes delta l
    and its swap in place, records its words' S-box inputs and outputs,
    and lane 0 the partial rounds' s0."""
    G = 4
    rec = WireRecorder()
    ins, swap = dep[:, :12].copy(), dep[:, 12]
    with np.errstate(over="ignore"):
        for lane in range(G):
            a, b = ins[:, lane], ins[:, lane + 4]
            rec.put(lane, lane, _mul(swap, _canon(b - a + np.where(
                b < a, np.uint64(P), np.uint64(0)))))
            ins[:, lane], ins[:, lane + 4] = (np.where(swap == 1, b, a),
                                              np.where(swap == 1, a, b))
    out = lane_split_permute(ins, G, rec)
    for w in range(12):
        rec.put(110 + w, w % G, out[:, w])
    return rec.writes


def test_k7_lane_map_writes_each_wire_once():
    """Every one of a row's 122 wires has exactly one writer lane (deltas
    and full-round wires: the lane of the word, w % 4; the partial rounds:
    lane 0), and the values are poseidon_wire_batch's, on random and
    boundary inputs under both swaps."""
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.hash import poseidon_wires as pw
    rng = np.random.default_rng(12)
    dep = _rand((16, 13), 13)
    dep[:6, :12] = BOUNDARY[rng.integers(0, 5, size=(6, 12))]
    dep[:, 12] = rng.integers(0, 2, size=16)
    writes = lane_split_wires(dep)
    assert sorted(writes) == list(range(pw.NUM_OUTPUT_WIRES))
    assert all(len(v) == 1 for v in writes.values())
    lanes = {k: v[0][0] for k, v in writes.items()}
    word = {k: (k - 4) % 12 if 4 <= k < 40 else (k - 62) % 12
            for k in list(range(4, 40)) + list(range(62, 110))}
    assert all(lanes[k] == k for k in range(4))
    assert all(lanes[k] == word[k] % 4 for k in word)
    assert all(lanes[k] == 0 for k in range(40, 62))
    assert all(lanes[110 + w] == w % 4 for w in range(12))
    want = convert.to_u64(pw.poseidon_wire_batch(from_u64(dep)))
    got = np.stack([writes[k][0][1] for k in range(pw.NUM_OUTPUT_WIRES)])
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_wrong_dtype():
    leaves = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        pc.hash_leaves_cols_cuda(leaves)
    with pytest.raises(TypeError):
        pc.compress_level_cuda(torch.zeros((4, 16), dtype=torch.float64))
    with pytest.raises(ValueError):
        pc.compress_level_cuda(torch.zeros((4, 15), dtype=torch.int64))
    with pytest.raises(TypeError):
        pc.compress_tail_cuda(torch.zeros((4, 16), dtype=torch.int32), 2)
    for shape, n_levels in (((4, 16), 0), ((4, 16), 5), ((3, 16), 1),
                            ((4, 12), 3)):
        with pytest.raises(ValueError):
            pc.compress_tail_cuda(torch.zeros(shape, dtype=torch.int64),
                                  n_levels)
