"""The port's field layer (plonky2_tpu_torch.field) against the JAX package's
(gf_jax, goldilocks, fft_numpy): same inputs through the converter, exact
equality (integer arithmetic)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_tpu.field import fft_numpy as fnp
from plonky2_tpu.field import gf_jax as gfj
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.utils import bits as jbits
from plonky2_tpu_torch.field import convert, fft, gf
from plonky2_tpu_torch.field import goldilocks as tgl
from plonky2_tpu_torch.utils import bits as tbits

P = jgl.P
BOUNDARY = [0, 1, (1 << 32) - 1, 1 << 32, P - 1, P - 2, (1 << 63), 12345]
# non-canonical representatives in [p, 2^64), for the *_nc operations
NON_CANONICAL = [P, P + 1, (1 << 64) - 1, (1 << 64) - 2, P + (1 << 31)]


def _canonical(seed, n=512):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=n, dtype=np.uint64)
    return np.concatenate([v, np.array(BOUNDARY, dtype=np.uint64)])


def _pairs(seed, extra=()):
    """All pairs of boundary values plus random ones, as two u64 arrays."""
    b = np.array(BOUNDARY + list(extra), dtype=np.uint64)
    a1, a2 = np.meshgrid(b, b)
    r = _canonical(seed)
    return (np.concatenate([a1.ravel(), r]),
            np.concatenate([a2.ravel(), r[::-1]]))


def _jax(fn, *us):
    out = fn(*(tuple(jnp.asarray(x) for x in gfj.from_u64(u)) for u in us))
    return gfj.to_u64((np.asarray(out[0]), np.asarray(out[1])))


def _port(fn, *us):
    return convert.to_u64(fn(*(convert.from_u64(u) for u in us)))


def test_constants_match():
    for name in ("P", "EPSILON", "TWO_ADICITY", "MULTIPLICATIVE_GROUP_GENERATOR",
                 "POWER_OF_TWO_GENERATOR"):
        assert getattr(tgl, name) == getattr(jgl, name), name
    for k in (0, 1, 5, 18, 32):
        assert tgl.primitive_root_of_unity(k) == jgl.primitive_root_of_unity(k)
    np.testing.assert_array_equal(tgl.powers(7, 1000), jgl.powers(7, 1000))
    assert tgl.s_inv(1 << 18) == jgl.s_inv(1 << 18)


def test_convert_round_trips():
    u = _canonical(1)
    t = convert.from_u64(u)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(convert.to_u64(t), u)
    lo, hi = convert.to_pair(t)
    jlo, jhi = gfj.from_u64(u)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(convert.to_u64(convert.from_pair((lo, hi))), u)


@pytest.mark.parametrize("name", ["add", "sub", "mul"])
def test_binary_ops_match_gf_jax_and_oracle(name):
    a, b = _pairs(2)
    got = _port(getattr(gf, name), a, b)
    np.testing.assert_array_equal(got, _jax(getattr(gfj, name), a, b))
    np.testing.assert_array_equal(got, getattr(jgl, name)(a, b))


@pytest.mark.parametrize("name", ["add_nc", "mul_nc"])
def test_non_canonical_binary_ops_match_gf_jax(name):
    # add_nc takes one non-canonical operand (the sponge adds a canonical
    # round constant); mul_nc takes any 64-bit representatives
    a, b = _pairs(4, extra=NON_CANONICAL)
    if name == "add_nc":
        b = np.where(b >= np.uint64(P), b - np.uint64(P), b)
    np.testing.assert_array_equal(_port(getattr(gf, name), a, b),
                                  _jax(getattr(gfj, name), a, b))


def test_reduce128_matches_gf_jax():
    # reduce128 / reduce128_nc on arbitrary 128-bit values (lo, hi)
    rng = np.random.default_rng(6)
    lo = np.concatenate([rng.integers(0, 1 << 64, 256, dtype=np.uint64),
                         np.array(NON_CANONICAL + BOUNDARY, np.uint64)])
    hi = np.concatenate([rng.integers(0, 1 << 64, 256, dtype=np.uint64),
                         np.array(BOUNDARY + NON_CANONICAL, np.uint64)])

    def jax_r(fn):
        l2, h2 = gfj.from_u64(lo), gfj.from_u64(hi)
        out = fn(jnp.asarray(l2[0]), jnp.asarray(l2[1]), jnp.asarray(h2[0]),
                 jnp.asarray(h2[1]))
        return gfj.to_u64((np.asarray(out[0]), np.asarray(out[1])))

    for port_fn, jax_fn in ((gf.reduce128, gfj.reduce128),
                            (gf.reduce128_nc, gfj.reduce128_nc)):
        got = convert.to_u64(port_fn(convert.from_u64(lo), convert.from_u64(hi)))
        np.testing.assert_array_equal(got, jax_r(jax_fn))
    np.testing.assert_array_equal(
        convert.to_u64(gf.reduce128(convert.from_u64(lo), convert.from_u64(hi))),
        jgl.reduce128(lo, hi))


def test_canon_matches_gf_jax():
    a = np.concatenate([_canonical(7), np.array(NON_CANONICAL, np.uint64)])
    lo, hi = gfj.from_u64(a)
    want = gfj.to_u64(tuple(np.asarray(x) for x in
                            gfj._canon(jnp.asarray(lo), jnp.asarray(hi))))
    np.testing.assert_array_equal(_port(gf.canon, a), want)


def test_exp_and_inverse_match_gf_jax():
    a = _canonical(8, n=64)
    np.testing.assert_array_equal(
        _port(lambda x: gf.exp_u64(x, 12345678901), a),
        _jax(lambda x: gfj.exp_u64(x, 12345678901), a))
    inv = _port(gf.inverse, a)
    np.testing.assert_array_equal(inv, _jax(gfj.inverse, a))
    nz = a != 0
    np.testing.assert_array_equal(jgl.mul(a[nz], inv[nz]), np.ones(nz.sum(), np.uint64))
    assert inv[a == 0].tolist() == [0]


def test_unsigned_helpers():
    a = convert.from_u64(np.array([0, 1, 1 << 63, (1 << 64) - 1], np.uint64))
    b = convert.from_u64(np.array([1, 0, 1, 1 << 63], np.uint64))
    assert gf.ult(a, b).tolist() == [True, False, False, False]
    np.testing.assert_array_equal(
        convert.to_u64(gf.srl(a, 32)),
        np.array([0, 0, 1 << 31, (1 << 32) - 1], np.uint64))
    assert gf.as_i64(P) == P - (1 << 64)


def test_bits_match():
    for n in (1, 2, 8, 1024):
        np.testing.assert_array_equal(tbits.bit_reverse_indices(n),
                                      jbits.bit_reverse_indices(n))
    assert tbits.reverse_bits(0b1011, 6) == jbits.reverse_bits(0b1011, 6)
    with pytest.raises(ValueError):
        tbits.log2_strict(12)


@pytest.mark.parametrize("n", [1, 2, 16, 512])
def test_fft_ifft_match_fft_numpy(n):
    rng = np.random.default_rng(9)
    v = rng.integers(0, P, size=(3, n), dtype=np.uint64)
    for port_fn, jax_fn in ((fft.fft, fnp.fft), (fft.ifft, fnp.ifft),
                            (fft.coset_fft, fnp.coset_fft)):
        np.testing.assert_array_equal(_port(port_fn, v), jax_fn(v))
    for s in range(tbits.log2_strict(n)):
        np.testing.assert_array_equal(fft.stage_twiddles(n)[s],
                                      fnp.stage_twiddles(n)[s])
        np.testing.assert_array_equal(fft.stage_twiddles(n, True)[s],
                                      fnp._inv_stage_twiddles(n)[s])


def test_dif_is_bit_reversed_dit():
    rng = np.random.default_rng(10)
    v = rng.integers(0, P, size=(2, 64), dtype=np.uint64)
    perm = tbits.bit_reverse_indices(64)
    for inverse in (False, True):
        t = convert.from_u64(v)
        np.testing.assert_array_equal(
            convert.to_u64(fft.dif(t, inverse)),
            convert.to_u64(fft.dit(t, inverse))[:, perm])
