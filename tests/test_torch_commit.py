"""The port's slice end to end against the JAX package on the CPU:
PolynomialBatch.from_values (IFFT -> coset LDE -> leaf hash -> Merkle levels)
at B = 12, n = 2^10, rate 3, cap 4, with and without salt, against the JAX
device pipeline; then query openings against the JAX DeviceMerkleTree.
Exact equality."""
import numpy as np
import pytest
import torch

from plonky2_tpu.field import gf_jax as gfj
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.fri.oracle import PolynomialBatch as JaxBatch
from plonky2_tpu.hash import merkle as jmk
from plonky2_tpu_torch.field.convert import to_u64
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.hash import merkle as tmk
from plonky2_tpu_torch.ops import commit

B, LOG_N, RATE, CAP = 12, 10, 3, 4


def _values(seed=0):
    return np.random.default_rng(seed).integers(0, jgl.P, size=(B, 1 << LOG_N),
                                                dtype=np.uint64)


def _salt_rng(blinding):
    return np.random.default_rng(5) if blinding else None


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "salted"])
def batches(request):
    blinding = request.param
    v = _values()
    port = PolynomialBatch.from_values(v, RATE, blinding, CAP, device="cpu",
                                       salt_rng=_salt_rng(blinding))
    ref = JaxBatch.from_values(v, RATE, blinding, CAP, use_device=True,
                               salt_rng=_salt_rng(blinding))
    return port, ref, blinding


def test_commit_matches_jax(batches):
    port, ref, blinding = batches
    assert port.leaves.shape == ((1 << (LOG_N + RATE)), B + 4 * blinding)
    np.testing.assert_array_equal(port.polynomials, ref.polynomials)
    np.testing.assert_array_equal(port.leaves, ref.leaves)
    levels = port.merkle_tree.levels_dev
    assert len(levels) == len(ref.merkle_tree.levels_dev) == LOG_N + RATE - CAP + 1
    for a, b in zip(levels, ref.merkle_tree.levels_dev):
        np.testing.assert_array_equal(to_u64(a), gfj.to_u64(b))
    np.testing.assert_array_equal(port.merkle_tree.cap.digests,
                                  ref.merkle_tree.cap.digests)


def test_openings_match_jax_and_verify(batches):
    port, ref, _ = batches
    idx = [int(i) for i in np.random.default_rng(1).integers(0, 1 << 13, 28)]
    port.merkle_tree.prefetch(idx)
    ref.merkle_tree.prefetch(idx)
    cap = port.merkle_tree.cap
    for i in idx:
        row = port.merkle_tree.get(i)
        np.testing.assert_array_equal(row, ref.merkle_tree.get(i))
        proof = port.merkle_tree.prove(i)
        for a, b in zip(proof.siblings, ref.merkle_tree.prove(i).siblings):
            np.testing.assert_array_equal(a, b)
        assert tmk.verify_merkle_proof_to_cap(row, i, cap, proof)
        assert jmk.verify_merkle_proof_to_cap(row, i, ref.merkle_tree.cap,
                                              jmk.MerkleProof(proof.siblings))
    bad = port.merkle_tree.get(idx[0]).copy()
    bad[3] = (int(bad[3]) + 1) % jgl.P
    assert not tmk.verify_merkle_proof_to_cap(bad, idx[0], cap,
                                              port.merkle_tree.prove(idx[0]))
    wrong = port.merkle_tree.prove(idx[0])
    wrong.siblings[2] = wrong.siblings[2].copy()
    wrong.siblings[2][0] ^= np.uint64(1)
    assert not tmk.verify_merkle_proof_to_cap(port.merkle_tree.get(idx[0]),
                                              idx[0], cap, wrong)


def test_from_coeffs_matches_from_values():
    v = _values(2)
    a = PolynomialBatch.from_values(v, RATE, False, CAP, device="cpu")
    b = PolynomialBatch.from_coeffs(a.polynomials, RATE, False, CAP,
                                    device="cpu")
    np.testing.assert_array_equal(a.leaves, b.leaves)
    np.testing.assert_array_equal(a.merkle_tree.cap.digests,
                                  b.merkle_tree.cap.digests)


def test_device_salt_matches_jax_draw_and_is_canonical():
    from plonky2_tpu.ops import commit as jcommit
    got = to_u64(commit.device_salt(64, "cpu",
                                    salt_rng=np.random.default_rng(3)))
    want = gfj.to_u64(jcommit.device_salt(64, salt_rng=np.random.default_rng(3)))
    np.testing.assert_array_equal(got, want)
    seeded = to_u64(commit.device_salt(1 << 12, "cpu", seed=7))
    assert seeded.shape == (4, 1 << 12) and (seeded < np.uint64(jgl.P)).all()
    np.testing.assert_array_equal(
        seeded, to_u64(commit.device_salt(1 << 12, "cpu", seed=7)))


def test_cpu_tensor_without_device_goes_to_cuda():
    """Only device="cpu" runs the plain versions: a CPU tensor with no device
    is moved to cuda, which this CUDA-less torch cannot do."""
    if torch.cuda.is_available():
        pytest.skip("tests/test_torch_cuda.py covers this on a card")
    v = torch.from_numpy(_values().view(np.int64))
    with pytest.raises((AssertionError, RuntimeError)):
        PolynomialBatch.from_values(v, RATE, False, CAP)
