"""The port's plain Poseidon (the plain versions of kernels K1 and K2) and its
Merkle levels against the JAX package: poseidon_jax (which the JAX package's
own tests hold bit-identical to the Pallas kernels), the numpy oracle and
merkle_jax.  Exact equality."""
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


def test_wrappers_reject_wrong_dtype():
    leaves = torch.zeros((8, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        pc.hash_leaves_cols_cuda(leaves)
    with pytest.raises(TypeError):
        pc.compress_level_cuda(torch.zeros((4, 16), dtype=torch.float64))
    with pytest.raises(ValueError):
        pc.compress_level_cuda(torch.zeros((4, 15), dtype=torch.int64))
