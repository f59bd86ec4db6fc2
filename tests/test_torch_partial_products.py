"""The port's partial products (ops/partial_products.py) against the JAX
package's host oracle (plonk/prover.py:_all_wires_partial_products) and its
device program (ops/partial_products.py:device_partial_products), on the
fibonacci circuit's proof and on random inputs where the routed wires do
not fill the last chunk.  Exact equality."""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

from plonky2_tpu.field import gf_jax as gfj
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.ops.partial_products import (_zs_pp_fn,
                                              device_partial_products as
                                              jax_device_partial_products)
from plonky2_tpu.plonk.prover import _all_wires_partial_products
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.ops import partial_products as tpp
from plonky2_tpu_torch.plonk.circuit_shape import CircuitShape

P = jgl.P


@functools.lru_cache(maxsize=1)
def fib_round():
    """The fibonacci circuit's proof run by the JAX host prover up to the
    quotient (as tests/test_constraint_program.py:_quotient_fixture does):
    witness, commitments, challenges, Z/PP values and the expected quotient
    coefficients."""
    from plonky2_tpu.fri.oracle import PolynomialBatch
    from plonky2_tpu.hash import poseidon as pos
    from plonky2_tpu.iop.challenger import Challenger
    from plonky2_tpu.iop.generator import generate_partial_witness
    from plonky2_tpu.models.fibonacci import build_fibonacci_circuit
    from plonky2_tpu.plonk.prover import _compute_quotient_polys
    from tests.test_plonk import fast_test_config

    data, pw, _ = build_fibonacci_circuit(fast_test_config())
    common, prover_only = data.common, data.prover_only
    config = common.config
    rate, zk = config.fri_config.rate_bits, config.zero_knowledge
    cap = config.fri_config.cap_height
    gc = common.hasher()
    pwit = generate_partial_witness(pw, prover_only, common)
    pih = pos.hash_no_pad(np.array(pwit.get_targets(prover_only.public_inputs),
                                   dtype=np.uint64))
    witness = pwit.full_witness()
    rng = np.random.default_rng(7)
    wires = PolynomialBatch.from_values(witness, rate, zk, cap,
                                        use_device=False, salt_rng=rng,
                                        hasher=gc)
    challenger = Challenger(permutation=gc.permute)
    challenger.observe_hash(prover_only.circuit_digest)
    challenger.observe_hash(pih)
    challenger.observe_cap(wires.merkle_tree.cap)
    betas = challenger.get_n_challenges(config.num_challenges)
    gammas = challenger.get_n_challenges(config.num_challenges)
    zspp = _all_wires_partial_products(witness, betas, gammas, prover_only,
                                       common)
    zspp_c = PolynomialBatch.from_values(zspp, rate, zk, cap,
                                         use_device=False, salt_rng=rng,
                                         hasher=gc)
    challenger.observe_cap(zspp_c.merkle_tree.cap)
    alphas = challenger.get_n_challenges(config.num_challenges)
    expected = _compute_quotient_polys(common, prover_only, pih, wires,
                                       zspp_c, betas, gammas, alphas)
    return SimpleNamespace(data=data, witness=witness, pih=pih, wires=wires,
                           zspp=zspp, zspp_c=zspp_c, betas=betas,
                           gammas=gammas, alphas=alphas, expected=expected)


def test_fib_partial_products_match_jax():
    r = fib_round()
    common, prover_only = r.data.common, r.data.prover_only
    shape = CircuitShape.from_common(common)
    want = r.zspp
    got = tpp.device_partial_products(
        from_u64(r.witness), from_u64(prover_only.sigmas.T.copy()), r.betas,
        r.gammas, shape)
    np.testing.assert_array_equal(to_u64(got), want)
    dev = jax_device_partial_products(gfj.from_u64(r.witness), r.betas,
                                      r.gammas, prover_only, common)
    np.testing.assert_array_equal(gfj.to_u64(dev), want)


@pytest.mark.parametrize("nr,qdf,nch,zeros", [(13, 4, 2, False),
                                              (10, 8, 1, False),
                                              (13, 4, 2, True)])
def test_random_partial_products_match_jax(nr, qdf, nch, zeros):
    """nr % qdf != 0: the last chunk is padded with ones.  With zeros, some
    denominators are 0 (the JAX package's inverse(0) == 0 then zeroes the
    chunk)."""
    degree_bits = 6
    degree = 1 << degree_bits
    rng = np.random.default_rng(nr * qdf)
    wires = rng.integers(0, P, size=(nr + 3, degree), dtype=np.uint64)
    sigmas = rng.integers(0, P, size=(nr, degree), dtype=np.uint64)
    k_is = [int(k) for k in rng.integers(1, P, size=nr, dtype=np.uint64)]
    betas = [int(x) for x in rng.integers(0, P, size=nch, dtype=np.uint64)]
    gammas = [int(x) for x in rng.integers(0, P, size=nch, dtype=np.uint64)]
    num_prods = -(-nr // qdf) - 1
    subgroup = jgl.two_adic_subgroup(degree_bits)
    if zeros:       # w = -(beta * sigma + gamma): denominator 0
        for i, j in ((0, 3), (5, 3), (12, 9), (7, 63)):
            t = (betas[0] * int(sigmas[i, j]) + gammas[0]) % P
            wires[i, j] = (P - t) % P

    common = SimpleNamespace(
        config=SimpleNamespace(num_routed_wires=nr, num_challenges=nch),
        quotient_degree_factor=qdf, num_partial_products=num_prods,
        k_is=k_is, degree=lambda: degree)
    prover = SimpleNamespace(subgroup=subgroup, sigmas=sigmas.T.copy())
    want = _all_wires_partial_products(wires, betas, gammas, prover, common)

    k_sub = jgl.mul(np.array(k_is, dtype=np.uint64)[:, None],
                    subgroup[None, :])
    fn = _zs_pp_fn(nr, degree, qdf, num_prods, nch)
    pair = lambda xs: np.stack(gfj.from_u64(np.array(xs, np.uint64)), 1)  # noqa: E731
    dev = fn(gfj.from_u64(wires[:nr]), gfj.from_u64(sigmas),
             gfj.from_u64(k_sub), pair(betas), pair(gammas))
    np.testing.assert_array_equal(gfj.to_u64(dev), want)

    shape = SimpleNamespace(num_routed_wires=nr, k_is=k_is,
                            degree_bits=degree_bits,
                            quotient_degree_factor=qdf,
                            num_partial_products=num_prods)
    got = tpp.device_partial_products(from_u64(wires), from_u64(sigmas),
                                      betas, gammas, shape)
    assert tuple(got.shape) == (nch * (1 + num_prods), degree)
    np.testing.assert_array_equal(to_u64(got), want)
    np.testing.assert_array_equal(
        to_u64(tpp.k_times_subgroup(tuple(k_is), degree_bits, "cpu")), k_sub)


def test_inverse_rows():
    x = np.random.default_rng(9).integers(0, P, size=(5, 40), dtype=np.uint64)
    x[2, 7] = x[0, 0] = x[4, 39] = 0
    x[1, 1] = 1
    got = to_u64(tpp.inverse_rows(from_u64(x)))
    np.testing.assert_array_equal(got, jgl.inverse(x.reshape(-1)).reshape(
        x.shape))
    assert got[2, 7] == 0 and got[1, 1] == 1


@pytest.mark.parametrize("n", [1, 2, 5, 64, 100])
def test_exclusive_prefix_product(n):
    x = np.random.default_rng(n).integers(0, P, size=(2, n), dtype=np.uint64)
    x[1, n // 2] = 0
    got = to_u64(tpp.exclusive_prefix_product(from_u64(x)))
    for row in range(2):
        np.testing.assert_array_equal(got[row],
                                      jgl.prefix_prod_exclusive(x[row]))
