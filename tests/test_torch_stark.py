"""The port's STARK prover and verifier (plonky2_tpu_torch/stark/) against
the JAX package's, on the CPU, for the Fibonacci STARK.

- The quotient: the STARK's constraints compiled into a constraint
  program (stark/quotient_program.py) and run through the plain version
  of kernel K6 give plonky2_tpu/stark/prover.py:_compute_quotient_polys
  exactly, on the same LDE leaves and challenges.
- The proof: under tests/test_stark.py:make_config the port's proof of
  2^6 rows equals the JAX package's field for field; the port's verifier
  accepts it, and rejects a wrong result, a tampered opening and the
  proof of a corrupted trace (the mirror of tests/test_stark.py).
- The harness: stark/testing.py's low-degree check and row-wise
  violations agree with the JAX package's.
Inputs are deterministic; equality is exact."""
import contextlib
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from plonky2_tpu.models.fibonacci_stark import FibonacciStark as JaxFib
from plonky2_tpu.stark import prover as jprover
from plonky2_tpu.stark import testing as jtesting
from plonky2_tpu.stark.permutation import (
    PermutationChallenge as JaxPermChallenge,
    PermutationChallengeSet as JaxPermSet)
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.fri.verifier import FriVerificationError
from plonky2_tpu_torch.models.fibonacci_stark import FibonacciStark
from plonky2_tpu_torch.ops import ntt
from plonky2_tpu_torch.stark import testing
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.permutation import (PermutationChallenge,
                                                 PermutationChallengeSet)
from plonky2_tpu_torch.stark.prover import prove
from plonky2_tpu_torch.stark.quotient_program import (quotient_context,
                                                      quotient_scalars,
                                                      stark_program)
from plonky2_tpu_torch.stark.verifier import (StarkVerificationError,
                                              verify_stark_proof)
from plonky2_tpu_torch.utils.serialization import proof_words
from tests.test_stark import make_config as jax_make_config
from tests.test_torch_prover import one_torch_thread  # noqa: F401

P = (1 << 64) - (1 << 32) + 1
REJECTED = (StarkVerificationError, FriVerificationError)


def make_config() -> StarkConfig:
    """tests/test_stark.py:make_config, in the port's classes."""
    return StarkConfig(
        security_bits=1, num_challenges=2,
        fri_config=FriConfig(
            rate_bits=1, cap_height=2, proof_of_work_bits=8,
            reduction_strategy=FriReductionStrategy.ConstantArityBits(2, 4),
            num_query_rounds=12))


@contextlib.contextmanager
def one_thread():
    """One intra-op torch thread inside a module fixture, which pytest
    sets up before the function-scoped ``one_torch_thread``."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def lde_batch(values: np.ndarray, rate_bits: int) -> SimpleNamespace:
    """What a commitment of the (B, n) values holds, without its tree:
    the coefficients and the coset LDE in leaf (bit-reversed) order, for
    both packages' quotient functions."""
    coeffs = ntt.ntt(from_u64(values), inverse=True)
    leaves = ntt.lde_coset_ntt_bitrev(coeffs, rate_bits)
    return SimpleNamespace(coeffs_dev=coeffs, leaves_dev=leaves,
                           leaves=to_u64(leaves).T.copy())


def random_challenge_sets(rng, num_sets: int, nch: int):
    """(port sets, JAX sets) of the same random ints."""
    vals = rng.integers(0, P, size=(num_sets, nch, 2),
                        dtype=np.uint64).tolist()
    port = [PermutationChallengeSet([PermutationChallenge(b, g)
                                     for b, g in s]) for s in vals]
    jax = [JaxPermSet([JaxPermChallenge(b, g) for b, g in s]) for s in vals]
    return port, jax


@pytest.fixture(scope="module")
def fib_proofs():
    """(stark, config, port proof, JAX proof, expected) at 2^6 rows."""
    n = 1 << 6
    stark, config = FibonacciStark(n), make_config()
    trace = stark.generate_trace(0, 1)
    expected = stark.expected_result(0, 1)
    jstark = JaxFib(n)
    np.testing.assert_array_equal(trace, jstark.generate_trace(0, 1))
    jproof = jprover.prove(jstark, jax_make_config(), trace,
                           [0, 1, expected], use_device=False)
    with one_thread():
        proof = prove(stark, config, trace, [0, 1, expected], device="cpu")
    return stark, config, proof, jproof, expected


def test_fib_quotient_program_equals_jax():
    n, rate_bits = 1 << 6, 1
    stark, config = FibonacciStark(n), make_config()
    trace = stark.generate_trace(3, 5)
    rng = np.random.default_rng(6)
    sets, jsets = random_challenge_sets(rng, stark.permutation_batch_size(),
                                        config.num_challenges)
    alphas = [int(a) for a in rng.integers(0, P, size=2, dtype=np.uint64)]
    pis = [3, 5, stark.expected_result(3, 5)]
    from plonky2_tpu_torch.stark.permutation import \
        compute_permutation_z_polys
    zs = to_u64(compute_permutation_z_polys(stark, config, from_u64(trace),
                                            sets))
    from plonky2_tpu.stark.permutation import \
        compute_permutation_z_polys as jax_zs
    np.testing.assert_array_equal(zs, jax_zs(JaxFib(n), jax_make_config(),
                                             trace, jsets))
    tb, zb = lde_batch(trace, rate_bits), lde_batch(zs, rate_bits)
    want = jprover._compute_quotient_polys(
        JaxFib(n), jax_make_config(), tb, zb, jsets, pis, alphas, 6)
    prog = stark_program(stark, config)
    ctx = quotient_context(stark, prog, 6, rate_bits, "cpu")
    got = ctx.compute(tb, zb, quotient_scalars(alphas, sets,
                                               public_inputs=pis))
    np.testing.assert_array_equal(to_u64(got).reshape(want.shape), want)
    assert stark_program(stark, config) is prog       # compiled once


def test_fib_proof_equals_jax(fib_proofs):
    _, _, proof, jproof, _ = fib_proofs
    assert proof.proof.permutation_zs_cap is not None
    assert list(proof_words(proof)) == list(proof_words(jproof))


def test_fib_verifier_accepts(fib_proofs):
    stark, config, proof, _, _ = fib_proofs
    verify_stark_proof(stark, proof, config)


def test_fib_verifier_rejects_wrong_result(fib_proofs):
    stark, config, proof, _, expected = fib_proofs
    bad = copy.deepcopy(proof)
    bad.public_inputs[2] = (expected + 1) % P
    with pytest.raises(REJECTED):
        verify_stark_proof(stark, bad, config)


def test_fib_verifier_rejects_tampered_opening(fib_proofs):
    stark, config, proof, _, _ = fib_proofs
    bad = copy.deepcopy(proof)
    bad.proof.openings.local_values[0][0] ^= np.uint64(1)
    with pytest.raises(REJECTED):
        verify_stark_proof(stark, bad, config)


def test_fib_corrupted_trace_proof_is_rejected():
    stark, config = FibonacciStark(1 << 5), make_config()
    trace = stark.generate_trace(0, 1)
    trace[1, 7] ^= np.uint64(1)             # breaks the transition at row 7
    proof = prove(stark, config, trace, [0, 1, stark.expected_result(0, 1)],
                  device="cpu")
    with pytest.raises(REJECTED):
        verify_stark_proof(stark, proof, config)


def test_harness_matches_jax():
    stark, jstark = FibonacciStark(1 << 5), JaxFib(1 << 5)
    testing.test_stark_low_degree(stark)
    jtesting.test_stark_low_degree(jstark)
    trace = stark.generate_trace(0, 1)
    pis = [0, 1, stark.expected_result(0, 1)]
    assert testing.trace_constraint_violations(stark, trace, pis) == []
    trace[1, 7] ^= np.uint64(1)
    got = testing.trace_constraint_violations(stark, trace, pis)
    assert got == jtesting.trace_constraint_violations(jstark, trace, pis)
    assert got
