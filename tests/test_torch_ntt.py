"""The plain versions of kernels K3 and K5 against the Pallas kernels run in
interpret mode, and the port's NTT functions (ops/ntt.py over the four-step
schedule) against plonky2_tpu/ops/ntt.py on both sides of its 2^12 switch.
Exact equality."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plonky2_tpu.field import fft_numpy as fnp
from plonky2_tpu.field import gf_jax as gfj
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.ops import ntt as jntt
from plonky2_tpu.ops import ntt_pallas as ntp
from plonky2_tpu_torch.field import convert, gf
from plonky2_tpu_torch.ops import ntt as tntt
from plonky2_tpu_torch.ops import ntt_cuda as nc
from plonky2_tpu_torch.parallel import four_step

P = jgl.P


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint64)


def _jax_pair(u):
    lo, hi = gfj.from_u64(u)
    return jnp.asarray(lo), jnp.asarray(hi)


def _from_jax(pair):
    return gfj.to_u64((np.asarray(pair[0]), np.asarray(pair[1])))


def _t(u):
    return convert.from_u64(u)


def _u(t):
    return convert.to_u64(t)


@pytest.mark.parametrize("shape,inverse", [((16, 128), False),
                                           ((64, 128), False),
                                           ((16, 128), True),
                                           ((3, 16, 128), False)])
def test_ntt_cols_matches_pallas_interpret(shape, inverse):
    v = _rand(shape, 1)
    want = _from_jax(ntp.ntt_cols_pallas(_jax_pair(v), inverse=inverse,
                                         tile=128, interpret=True))
    np.testing.assert_array_equal(_u(nc.ntt_cols(_t(v), inverse)), want)
    # the K3 wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(_u(nc.ntt_cols_cuda(_t(v), inverse)), want)


@pytest.mark.parametrize("q,tail", [(16, 0), (4, 12), (8, 56)])
def test_ntt_cols_dif_matches_pallas_interpret(q, tail):
    v = _rand((2, q, 128), 2 + q)
    want = _from_jax(ntp.ntt_cols_dif_pallas(_jax_pair(v), tile=128,
                                             interpret=True,
                                             zero_tail_rows=tail))
    np.testing.assert_array_equal(_u(nc.ntt_cols_dif(_t(v), tail)), want)
    np.testing.assert_array_equal(_u(nc.ntt_cols_dif_cuda(_t(v), tail)), want)


def test_fused_factors_are_pointwise_products():
    v, pre, post = _rand((2, 8, 16), 3), _rand((8, 16), 4), _rand((8, 16), 5)
    got = nc.ntt_cols(_t(v), True, pre=_t(pre), post=_t(post))
    want = gf.mul(nc.ntt_cols(gf.mul(_t(v), _t(pre)), True), _t(post))
    np.testing.assert_array_equal(_u(got), _u(want))
    q_pre = _rand((2, 16), 6)
    got = nc.ntt_cols_dif(_t(v[:, :2]), 6, pre=_t(q_pre), post=_t(post))
    want = gf.mul(nc.ntt_cols_dif(gf.mul(_t(v[:, :2]), _t(q_pre)), 6),
                  _t(post))
    np.testing.assert_array_equal(_u(got), _u(want))


def test_step2_twiddles_match_sharded_ntt():
    from plonky2_tpu.parallel import sharded_ntt as fs
    from plonky2_tpu.utils.bits import bit_reverse_indices
    for inverse in (False, True):
        want = gfj.to_u64(fs._step2_twiddles(16, 32, inverse))
        got = four_step.step2_twiddles(16, 32, inverse, False, 1, "cpu")
        np.testing.assert_array_equal(_u(got), want)
    got = four_step.step2_twiddles(16, 32, False, True, 1, "cpu")
    np.testing.assert_array_equal(
        _u(got), gfj.to_u64(fs._step2_twiddles(16, 32, False))[
            bit_reverse_indices(16)])


@pytest.mark.parametrize("n", [1 << 11, 1 << 13])
def test_ntt_matches_jax(n):
    v = _rand((2, n), 7)
    for inverse in (False, True):
        want = _from_jax(jntt.ntt_jit(_jax_pair(v), inverse))
        np.testing.assert_array_equal(_u(tntt.ntt(_t(v), inverse)), want)
    # one polynomial as a 1-D tensor
    np.testing.assert_array_equal(_u(tntt.ntt(_t(v[0]))), fnp.fft(v[0]))


def test_cosets_match_jax():
    v = _rand((2, 1 << 11), 7)
    np.testing.assert_array_equal(
        _u(tntt.coset_ntt(_t(v))),
        _from_jax(jax.jit(jntt.coset_ntt)(_jax_pair(v))))
    np.testing.assert_array_equal(
        _u(tntt.coset_intt(_t(v))),
        _from_jax(jax.jit(jntt.coset_intt)(_jax_pair(v))))


@pytest.mark.parametrize("q", [1 << 8, 1 << 10])
def test_lde_matches_jax_both_sides_of_switch(q):
    """m = q * 8: 2^11 takes the JAX package's flat path, 2^13 its
    four-step path; the port's functions give the same bits on both."""
    v = _rand((2, q), 8)
    want_nat = _from_jax(jax.jit(jntt.lde_coset_ntt, static_argnums=1)(
        _jax_pair(v), 3))
    want_rev = _from_jax(jax.jit(jntt.lde_coset_ntt_bitrev, static_argnums=1)(
        _jax_pair(v), 3))
    np.testing.assert_array_equal(_u(tntt.lde_coset_ntt(_t(v), 3)), want_nat)
    np.testing.assert_array_equal(_u(tntt.lde_coset_ntt_bitrev(_t(v), 3)),
                                  want_rev)


def test_four_step_schedules_match_oracle():
    q, r = 1 << 10, 3
    v = _rand((2, q), 9)
    m = q << r
    padded = np.zeros((2, m), dtype=np.uint64)
    padded[:, :q] = v
    from plonky2_tpu_torch.utils.bits import bit_reverse_indices
    want = np.stack([fnp.fft(padded[b])[bit_reverse_indices(m)]
                     for b in range(2)])
    np.testing.assert_array_equal(
        _u(four_step.batched_four_step_zero_tail_bitrev(_t(v), r)), want)
    np.testing.assert_array_equal(
        _u(four_step.batched_four_step_ntt(_t(v), True)), fnp.ifft(v))


def test_ntt_wrappers_reject_wrong_dtype():
    with pytest.raises(TypeError):
        nc.ntt_cols_cuda(torch.zeros((16, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        nc.ntt_cols_dif_cuda(torch.zeros((16, 8), dtype=torch.uint8), 16)
    with pytest.raises(ValueError):
        nc.ntt_cols_cuda(torch.zeros((16,), dtype=torch.int64))
