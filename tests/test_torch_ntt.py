"""The plain versions of kernels K3, K4 and K5 against the Pallas kernels run
in interpret mode, and the port's NTT functions (ops/ntt.py over the
four-step schedules) against plonky2_tpu/ops/ntt.py on both sides of its
2^12 switch and plonky2_tpu/parallel/sharded_ntt.py.  Exact equality."""
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


@pytest.mark.parametrize("q,r,batch", [(16, 3, 2), (2, 3, 1), (1, 3, 2),
                                        (8, 1, 0), (16, 0, 2)])
def test_ntt_cols_zero_tail_matches_pallas_interpret(q, r, batch):
    shape = (batch, q, 128) if batch else (q, 128)
    v = _rand(shape, 20 + q + r)
    if batch:       # boundary values in one batch entry
        bnd = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - 1], np.uint64)
        v[0] = bnd[np.random.default_rng(q).integers(0, 5, size=(q, 128))]
    want = _from_jax(ntp.ntt_cols_zero_tail_pallas(_jax_pair(v), r, tile=128,
                                                   interpret=True))
    got = nc.ntt_cols_zero_tail(_t(v), r)
    assert tuple(got.shape) == shape[:-2] + (q << r, 128)
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(_u(nc.ntt_cols_zero_tail_cuda(_t(v), r)),
                                  want)


@pytest.mark.parametrize("q,r", [(1 << 9, 3), (1 << 11, 1), (1 << 10, 3)])
def test_four_step_zero_tail_matches_sharded_ntt(q, r):
    """m = q * 2^r >= 2^12: the natural-order zero-tail four-step (K4 then
    K3) against the JAX package's schedule, coset shift included."""
    from plonky2_tpu.parallel import sharded_ntt as fs
    v = _rand((2, q), 30 + r)
    want = _from_jax(jax.jit(fs.batched_four_step_zero_tail_ntt,
                             static_argnums=1)(_jax_pair(v), r))
    np.testing.assert_array_equal(
        _u(four_step.batched_four_step_zero_tail_ntt(_t(v), r)), want)
    want_lde = _from_jax(jax.jit(jntt.lde_coset_ntt, static_argnums=1)(
        _jax_pair(v), r))
    np.testing.assert_array_equal(_u(tntt.lde_coset_ntt(_t(v), r)), want_lde)


@pytest.mark.parametrize("shape", [(8, 16), (2, 16, 8), (3, 4, 32),
                                   (2, 1, 8)])
@pytest.mark.parametrize("form", ["dit", "dif"])
def test_row_forms_equal_column_forms_on_transposed_input(shape, form):
    """The plain row forms against the plain column forms on the transposed
    input: K3's, stored transposed, with its post factor, forward and
    inverse; K5's.  The wrappers take them for a CPU tensor, K5's in
    place."""
    n1, n2 = shape[-2:]
    v = _t(_rand(shape, 40 + n1))
    post_t = _t(_rand((n2, n1), 42))
    vt = v.transpose(-1, -2).contiguous()
    if form == "dif":
        want = nc.ntt_cols_dif(vt).transpose(-1, -2)
        cases = [(nc.ntt_rows_dif(v), want)]
        x = v.clone()
        assert nc.ntt_rows_dif_cuda(x) is x
        cases.append((x, want))
    else:
        cases = []
        for inverse in (False, True):
            want = nc.ntt_cols(vt, inverse)
            cases += [(nc.ntt_rows(v, inverse), want),
                      (nc.ntt_rows_cuda(v, inverse), want),
                      (nc.ntt_rows(v, inverse, post_t),
                       nc.ntt_cols(vt, inverse, post=post_t))]
    for got, want in cases:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_u(got), _u(want))


@pytest.mark.parametrize("n1,r", [(16, 3), (1024, 3), (64, 1), (2, 1),
                                  (8, 0)])
def test_zero_tail_factors_replace_first_dif_stages(n1, r):
    """K4's and K5's zero tail: the first r DIF stages on [prefix; zeros]
    leave segment c as prefix * factors[c * Q:(c + 1) * Q], each segment
    then a Q-point DIF of its own (Q = n1 / 2^r)."""
    q = n1 >> r
    prefix = _t(_rand((q, 4), 50 + n1))
    fac = _t(nc.zero_tail_factors_u64(n1, r)).reshape(1 << r, q)
    np.testing.assert_array_equal(_u(fac[0]), np.ones(q, np.uint64))
    segments = [nc.ntt_cols_dif(gf.mul(prefix, fac[c][:, None]))
                for c in range(1 << r)]
    np.testing.assert_array_equal(
        _u(torch.cat(segments)),
        _u(nc.ntt_cols_dif(prefix, n1 - q)))


@pytest.mark.parametrize("log_n,B", [(9, 1), (11, 3), (13, 1), (13, 3)])
def test_transpose_free_four_step_ntt_matches_sharded_ntt(log_n, B):
    """n1 != n2 (odd log2 n): K3 down the columns, K3's row form with the
    transposed store, against the JAX package's schedule."""
    from plonky2_tpu.parallel import sharded_ntt as fs
    v = _rand((B, 1 << log_n), 60 + log_n)
    for inverse in (False, True):
        want = _from_jax(jax.jit(fs.batched_four_step_ntt,
                                 static_argnums=1)(_jax_pair(v), inverse))
        np.testing.assert_array_equal(
            _u(four_step.batched_four_step_ntt(_t(v), inverse)), want)


@pytest.mark.parametrize("log_m,r,B", [(9, 1, 1), (11, 2, 3), (13, 3, 1),
                                       (11, 3, 3), (13, 1, 3)])
def test_transpose_free_zero_tail_schedules_match_sharded_ntt(
        log_m, r, B, monkeypatch):
    """Both zero-tail schedules at n1 != n2: natural order (K4, then K3's
    row form) against the JAX batched_four_step_zero_tail_ntt; leaf order
    (K5, then K5's row form in place) against the JAX
    _four_step_zero_tail_bitrev_pallas in interpret mode."""
    from plonky2_tpu.parallel import sharded_ntt as fs
    q = 1 << (log_m - r)
    v = _rand((B, q), 70 + log_m + r)
    want = _from_jax(jax.jit(fs.batched_four_step_zero_tail_ntt,
                             static_argnums=1)(_jax_pair(v), r))
    np.testing.assert_array_equal(
        _u(four_step.batched_four_step_zero_tail_ntt(_t(v), r)), want)
    monkeypatch.setenv("PLONKY2_TPU_PALLAS_NTT", "interpret")
    n1 = max(1 << (log_m // 2), 1 << r)
    want = _from_jax(jax.jit(fs._four_step_zero_tail_bitrev_pallas,
                             static_argnums=(1, 2))(_jax_pair(v), r, n1))
    np.testing.assert_array_equal(
        _u(four_step.batched_four_step_zero_tail_bitrev(_t(v), r)), want)


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
    got = nc.ntt_cols_zero_tail(_t(v[:, :2]), 2, pre=_t(q_pre),
                                post=_t(post))
    want = gf.mul(nc.ntt_cols_zero_tail(gf.mul(_t(v[:, :2]), _t(q_pre)), 2),
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
    with pytest.raises(TypeError):
        nc.ntt_cols_zero_tail_cuda(torch.zeros((2, 8), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        nc.ntt_cols_zero_tail_cuda(torch.zeros((2, 8), dtype=torch.int64), -1)
