"""The port's FRI opening proof against the JAX package, on the CPU.

Random committed oracles (3 batches of 5, 7 and 3 polynomials) are opened
at a point z and at a second point for two polynomials, with the claimed
values computed by the JAX package's host evaluation; each side's
transcript starts from the same observations.  Held equal, bit for bit:

- the reduction strategies' arity sequences;
- the composition's values (leaf order) and coefficients, against JAX
  ``device_composition`` (in the degree at which its XLA programs compile
  in seconds here) and against the JAX host path's synthetic division;
- the fold layers: each layer tree's leaves and cap, the final
  polynomial and the transcript, against JAX ``fri_committed_trees``;
- the whole ``FriProof`` (serialized) and the transcript after it,
  against JAX ``PolynomialBatch.prove_openings``.  The JAX package's
  layered ``device_prove_openings`` gives the same proof (its fused path
  asserts so), but its fold programs take many minutes to compile for the
  CPU, so the host prover stands in for it here;
- the flagship arity 16 (two layers) and the arity 256 of
  ``__graft_entry__.py:_fast_config`` (one layer);
- a wrong claimed value leaves the final polynomial's tail nonzero, which
  the prover refuses.

The whole proof and the wrong claim go through both FRI paths: the fused
one, whose transcript runs on the device (iop/challenger_torch.py, K9's
plain version here) and the host replays it, and the layered one.
"""
import functools

import numpy as np
import pytest
import torch

from plonky2_tpu.field import extension as jext
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.fri import config as jcfg
from plonky2_tpu.fri import structure as js
from plonky2_tpu.fri.oracle import PolynomialBatch as JaxBatch
from plonky2_tpu.iop.challenger import Challenger as JaxChallenger
from plonky2_tpu.ops.openings import ext_powers_host
from plonky2_tpu.utils.bits import bit_reverse_indices
from plonky2_tpu.utils.serialization import Buffer
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri import config as tcfg
from plonky2_tpu_torch.fri import device_prover as tdp
from plonky2_tpu_torch.fri import structure as ts
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.iop.challenger import Challenger
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.plonk.prover_data import fri_params_from
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import to_jax_fri_proof

P = jgl.P
SIZES = (5, 7, 3)
PREFIX = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]    # the transcript so far
FLAGSHIP_ARITY = jcfg.FriConfig(
    rate_bits=3, cap_height=2, proof_of_work_bits=8,
    reduction_strategy=jcfg.FriReductionStrategy.ConstantArityBits(4, 5),
    num_query_rounds=8)
GRAFT_ARITY = jcfg.FriConfig(      # __graft_entry__.py:_fast_config
    rate_bits=3, cap_height=5, proof_of_work_bits=8,
    reduction_strategy=jcfg.FriReductionStrategy.ConstantArityBits(8, 5),
    num_query_rounds=8)


@functools.lru_cache(maxsize=4)
def case(logn: int, cap_height: int, seed: int = 1):
    """Random oracles (JAX host batches and the port's), an instance with
    two opening batches, and the claimed values."""
    rng = np.random.default_rng(seed)
    polys = [rng.integers(0, P, size=(k, 1 << logn), dtype=np.uint64)
             for k in SIZES]
    polys[0][0, :5] = [0, 1, (1 << 32) - 1, 1 << 32, P - 1]
    jo = [JaxBatch.from_coeffs(p, 3, False, cap_height, use_device=False)
          for p in polys]
    to = [PolynomialBatch.from_coeffs(p, 3, False, cap_height, device="cpu")
          for p in polys]
    zeta = tuple(int(x) for x in rng.integers(0, P, 2, dtype=np.uint64))
    g = jgl.primitive_root_of_unity(logn)
    points = [zeta, jext.s_mul(zeta, (g, 0))]
    members = [[(o, i) for o, k in enumerate(SIZES) for i in range(k)],
               [(1, 0), (1, 4), (2, 2)]]
    values = []
    for z, m in zip(points, members):
        zp = ext_powers_host(z, 1 << logn)
        values.append([tuple(int(jgl.modsum(jgl.mul(polys[o][i], zp[:, c])))
                             for c in range(2)) for o, i in m])
    jinst = js.FriInstanceInfo(
        oracles=[js.FriOracleInfo(k, False) for k in SIZES],
        batches=[js.FriBatchInfo(point=z, polynomials=[
            js.FriPolynomialInfo(o, i) for o, i in m])
            for z, m in zip(points, members)])
    tinst = ts.FriInstanceInfo(
        oracles=[ts.FriOracleInfo(k, False) for k in SIZES],
        batches=[ts.FriBatchInfo(point=z, polynomials=[
            ts.FriPolynomialInfo(o, i) for o, i in m])
            for z, m in zip(points, members)])
    jopen = js.FriOpenings([js.FriOpeningBatch(v) for v in values])
    topen = ts.FriOpenings([ts.FriOpeningBatch(v) for v in values])
    return jo, to, jinst, tinst, jopen, topen


def challengers():
    ours, ref = Challenger(), JaxChallenger()
    ours.observe_elements(PREFIX)
    ref.observe_elements(PREFIX)
    return ours, ref


def host_composition(jo, jinst, alpha):
    """The JAX host path's composition (fri/oracle.py:prove_openings): the
    (N, 2) coefficients and their natural-order values."""
    from plonky2_tpu.fri.oracle import (_divide_by_linear_ext,
                                        _reduce_polys_base)
    from plonky2_tpu.fri.prover import coset_fft_ext
    degree = jo[0].polynomials.shape[-1]
    final = np.zeros((degree - 1, 2), dtype=np.uint64)
    for batch in jinst.batches:
        polys = np.stack([jo[p.oracle_index].polynomials[p.polynomial_index]
                          for p in batch.polynomials])
        q = _divide_by_linear_ext(_reduce_polys_base(polys, alpha),
                                  batch.point)
        shift = np.array(jext.s_exp(alpha, len(polys)), dtype=np.uint64)
        final = jext.add(jext.mul(final, np.broadcast_to(shift, final.shape)),
                         q)
    coeffs = np.zeros((degree << 3, 2), dtype=np.uint64)
    coeffs[1:degree] = final
    return coeffs, coset_fft_ext(coeffs, jgl.coset_shift())


@pytest.mark.parametrize("degree_bits,rate_bits,cap,queries", [
    (18, 3, 4, 28), (10, 3, 2, 8), (10, 3, 5, 8), (13, 1, 0, 40),
    (5, 3, 2, 8), (3, 2, 0, 2)])
def test_reduction_arity_bits_match_jax(degree_bits, rate_bits, cap, queries):
    strategies = [("ConstantArityBits", (4, 5)), ("ConstantArityBits", (8, 5)),
                  ("ConstantArityBits", (2, 3)), ("MinSize", (None,)),
                  ("MinSize", (3,)), ("Fixed", ((3, 2, 1),))]
    for name, args in strategies:
        ours = getattr(tcfg.FriReductionStrategy, name)(*args)
        ref = getattr(jcfg.FriReductionStrategy, name)(*args)
        for hiding in (False, True):
            jp = jcfg.FriConfig(rate_bits, cap, 16, ref, queries).fri_params(
                degree_bits, hiding)
            tp = tcfg.FriConfig(rate_bits, cap, 16, ours, queries).fri_params(
                degree_bits, hiding)
            assert tp.reduction_arity_bits == jp.reduction_arity_bits
            assert tp.final_poly_bits() == jp.final_poly_bits()
            assert fri_params_from(jp) == tp


def test_composition_matches_jax_device_composition():
    from plonky2_tpu.field import gf_jax as gfj
    from plonky2_tpu.fri.device_prover import device_composition
    logn = 8
    jo, to, jinst, tinst, jopen, topen = case(logn, 2)
    alpha = (987654321987, 123456789123)
    (jv0, jv1), jc = device_composition(jinst, jo, alpha, jopen.batches,
                                        logn + 3)
    (v0, v1), coeffs = tdp.device_composition(tinst, to, alpha,
                                              topen.batches, logn + 3)
    np.testing.assert_array_equal(to_u64(v0), gfj.to_u64(jv0))
    np.testing.assert_array_equal(to_u64(v1), gfj.to_u64(jv1))
    np.testing.assert_array_equal(to_u64(coeffs), gfj.to_u64(jc))
    # the host path's coefficients and values, in leaf order
    hc, hv = host_composition(jo, jinst, alpha)
    np.testing.assert_array_equal(to_u64(coeffs), hc.T)
    perm = bit_reverse_indices(hv.shape[0])
    np.testing.assert_array_equal(to_u64(v0), hv[perm, 0])


@pytest.mark.parametrize("config,logn,layers", [(FLAGSHIP_ARITY, 10, 2),
                                                (GRAFT_ARITY, 10, 1)])
def test_fold_layers_match_jax(config, logn, layers):
    from plonky2_tpu.fri.prover import fri_committed_trees
    jo, to, jinst, tinst, jopen, topen = case(logn, config.cap_height)
    params = config.fri_params(logn, False)
    assert len(params.reduction_arity_bits) == layers
    ours, ref = challengers()
    alpha = ours.get_extension_challenge()
    assert alpha == ref.get_extension_challenge()
    values_br, coeffs = tdp.device_composition(tinst, to, alpha,
                                               topen.batches, logn + 3)
    hc, hv = host_composition(jo, jinst, alpha)
    trees, final = tdp.device_fri_committed_trees(
        coeffs, values_br, ours, fri_params_from(params))
    jtrees, jfinal = fri_committed_trees(hc, hv, ref, params)
    assert len(trees) == len(jtrees) == layers
    for t, jt in zip(trees, jtrees):
        np.testing.assert_array_equal(t.cap.digests, jt.cap.digests)
        np.testing.assert_array_equal(to_u64(t.leaves_dev).T, jt.leaves)
    np.testing.assert_array_equal(final, jfinal)
    assert ours.sponge_state == [int(x) for x in ref.sponge_state]
    assert ours.get_n_challenges(3) == ref.get_n_challenges(3)


def take_path(monkeypatch, path: str) -> None:
    """Make device_prove_openings take the fused or the layered FRI."""
    if path == "layered":
        monkeypatch.setattr(tdp, "device_fri_proof",
                            tdp._device_fri_proof_layered)
    else:
        monkeypatch.setattr(tdp, "_device_fri_proof_layered",
                            lambda *a, **k: pytest.fail("layered path ran"))


@pytest.mark.parametrize("path", ["fused", "layered"])
@pytest.mark.parametrize("config,logn", [(FLAGSHIP_ARITY, 10),
                                         (GRAFT_ARITY, 10)])
def test_fri_proof_matches_jax(config, logn, path, monkeypatch):
    jo, to, jinst, tinst, jopen, topen = case(logn, config.cap_height)
    params = config.fri_params(logn, False)
    take_path(monkeypatch, path)
    ours, ref = challengers()
    proof = tdp.device_prove_openings(tinst, to, topen, ours,
                                      fri_params_from(params))
    want = JaxBatch.prove_openings(jinst, jo, ref, params)
    a, b = Buffer(), Buffer()
    a.write_fri_proof(to_jax_fri_proof(proof))
    b.write_fri_proof(want)
    assert a.bytes() == b.bytes()
    assert ours.sponge_state == [int(x) for x in ref.sponge_state]
    # every query path verifies against its cap
    from plonky2_tpu_torch.hash.merkle import verify_merkle_proof_to_cap
    leaves = [to_u64(t.leaves_dev).T for t in to]
    for r in proof.query_round_proofs:
        for t, rows, (row, path) in zip(to, leaves,
                                        r.initial_trees_proof.evals_proofs):
            idx = int(np.flatnonzero((rows == row).all(1))[0])
            assert verify_merkle_proof_to_cap(row, idx, t.merkle_tree.cap,
                                              path)


@pytest.mark.parametrize("path", ["fused", "layered"])
def test_wrong_claimed_value_leaves_a_nonzero_tail(path, monkeypatch):
    logn = 8
    take_path(monkeypatch, path)
    jo, to, jinst, tinst, jopen, topen = case(logn, 2)
    bad = ts.FriOpenings([ts.FriOpeningBatch(list(b.values))
                          for b in topen.batches])
    v = bad.batches[0].values[3]
    bad.batches[0].values[3] = ((v[0] + 1) % P, v[1])
    params = fri_params_from(FLAGSHIP_ARITY.fri_params(logn, False))
    ours, _ = challengers()
    with pytest.raises(RuntimeError, match="tail is not zero"):
        tdp.device_prove_openings(tinst, to, bad, ours, params)


@pytest.mark.parametrize("log_n", [1, 2, 5, 9, 12])
def test_fold_values_in_leaf_order(log_n):
    """K5's rate-0 LDE with a shift (the folds' evaluation) equals the
    coset NTT followed by the bit-reversal permutation."""
    rng = np.random.default_rng(log_n)
    coeffs = from_u64(rng.integers(0, P, size=(2, 1 << log_n),
                                   dtype=np.uint64))
    shift = pow(7, 16, P)
    perm = torch.from_numpy(bit_reverse_indices(1 << log_n))
    got = ntt.lde_coset_ntt_bitrev(coeffs, 0, shift)
    assert torch.equal(got, ntt.coset_ntt(coeffs, shift)[:, perm])


@pytest.mark.parametrize("arity_bits", [1, 4, 8])
def test_fold_coeffs_match_jax_horner(arity_bits):
    from plonky2_tpu.fri.prover import _reduce_with_powers_ext
    rng = np.random.default_rng(arity_bits)
    arity, m = 1 << arity_bits, 8
    c = rng.integers(0, P, size=(m * arity, 2), dtype=np.uint64)
    c[:5, 0] = [0, 1, (1 << 32) - 1, 1 << 32, P - 1]
    beta = (P - 1, (1 << 32) + 5)
    want = _reduce_with_powers_ext(c.reshape(m, arity, 2), beta)
    got = tdp.fold_coeffs(from_u64(c.T.copy()), beta, arity)
    np.testing.assert_array_equal(to_u64(got), want.T)
