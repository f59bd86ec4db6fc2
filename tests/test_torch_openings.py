"""The port's opened values and opening set against the JAX package.

- ``ext_powers`` against ``ext_powers_host``;
- ``eval_openings_batched`` and ``eval_device_polys_ext`` against the JAX
  device functions of the same names, with the rows in one chunk and in
  many;
- ``OpeningSet.new`` and ``to_fri_openings`` on the fibonacci circuit's
  commitments (tests/test_torch_partial_products.py:fib_round), against the
  JAX ``OpeningSet.new``.

Exact equality throughout."""
import numpy as np
import pytest

from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.fri.oracle import PolynomialBatch as JaxBatch
from plonky2_tpu.ops import openings as jop
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.ops import openings as top
from tests.test_torch_prover import one_torch_thread  # noqa: F401

P = jgl.P
BOUNDARY = [0, 1, (1 << 32) - 1, 1 << 32, P - 1]
POINTS = [(0, 1), (P - 1, P - 1), (1 << 32, (1 << 32) - 1),
          (1234567890123456789, 987654321987654321)]


@pytest.mark.parametrize("n", [1, 2, 5, 64, 1000, 4096])
def test_ext_powers_match_jax(n):
    for z in POINTS:
        c0, c1 = top.ext_powers(z, n, "cpu")
        want = jop.ext_powers_host(z, n)
        np.testing.assert_array_equal(to_u64(c0), want[:, 0])
        np.testing.assert_array_equal(to_u64(c1), want[:, 1])


@pytest.mark.parametrize("chunk_elems", [1 << 24, 1000])
def test_eval_openings_match_jax(monkeypatch, chunk_elems):
    monkeypatch.setattr(top, "CHUNK_ELEMS", chunk_elems)
    rng = np.random.default_rng(3)
    polys = [rng.integers(0, P, size=(k, 256), dtype=np.uint64)
             for k in (5, 9, 2)]
    polys[0][:, :5] = BOUNDARY
    polys[1][0] = P - 1
    ours = [PolynomialBatch.from_coeffs(p, 1, False, 0, device="cpu")
            for p in polys]
    ref = [JaxBatch.from_coeffs(p, 1, False, 0, use_device=False)
           for p in polys]
    points = POINTS[1:3]
    got = top.eval_openings_batched(ours, points)
    want = jop.eval_openings_batched(ref, points)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    zp = jop.ext_powers_host(POINTS[3], 256)
    np.testing.assert_array_equal(
        top.eval_device_polys_ext(from_u64(polys[1]),
                                  top.ext_powers(POINTS[3], 256, "cpu")),
        jop.eval_device_polys_ext(ref[1], zp))


def test_opening_set_matches_jax_on_fibonacci():
    from plonky2_tpu.plonk.proof import OpeningSet as JaxOpeningSet
    from plonky2_tpu.plonk.quotient_program import build_quotient_program
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk.proof import OpeningSet
    from plonky2_tpu_torch.plonk.prover_data import ProverData
    from tests.test_torch_partial_products import fib_round
    r = fib_round()
    common, prover_only = r.data.common, r.data.prover_only
    shape_q = common.num_quotient_polys()
    chunks = r.expected.reshape(shape_q, common.degree())
    rate, cap = common.config.fri_config.rate_bits, \
        common.config.fri_config.cap_height
    quotient = JaxBatch.from_coeffs(chunks, rate, False, cap,
                                    use_device=False)
    jax_oracles = [prover_only.constants_sigmas_commitment, r.wires,
                   r.zspp_c, quotient]
    ours = [PolynomialBatch.from_coeffs(o.polynomials, rate, False, cap,
                                        device="cpu") for o in jax_oracles]
    data = ProverData.from_circuit(
        prover_only, common,
        cp.program_from_arrays(build_quotient_program(common)))
    g = jgl.primitive_root_of_unity(common.degree_bits())
    for zeta in POINTS[1:]:
        got = OpeningSet.new(zeta, g, *ours, data)
        want = JaxOpeningSet.new(zeta, g, *jax_oracles, common)
        for name in ("constants", "plonk_sigmas", "wires", "plonk_zs",
                     "plonk_zs_next", "partial_products", "quotient_polys"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        a, b = got.to_fri_openings(), want.to_fri_openings()
        assert [x.values for x in a.batches] == [x.values for x in b.batches]
