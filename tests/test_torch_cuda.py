"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports jax.)"""
import numpy as np
import pytest
import torch

from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.field.goldilocks import P
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.hash import poseidon_cuda as pc
from plonky2_tpu_torch.ops import ntt_cuda as nc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), dev)


def _equal(a, b):
    np.testing.assert_array_equal(to_u64(a), to_u64(b))


@pytest.mark.parametrize("L", [5, 12, 234])
def test_hash_leaves_kernel(dev, L):
    leaves = _rand((L, 1024), L, dev)
    before = pc.hash_leaves_cols_cuda.launches
    _equal(pc.hash_leaves_cols_cuda(leaves), pos.hash_leaves_cols(leaves))
    assert pc.hash_leaves_cols_cuda.launches == before + 1


def test_compress_level_kernel(dev):
    level = _rand((4, 2048), 1, dev)
    _equal(pc.compress_level_cuda(level), pc.compress_level(level))


@pytest.mark.parametrize("n1,n2", [(16, 128), (512, 64), (2048, 8)])
def test_ntt_cols_kernel(dev, n1, n2):
    a = _rand((2, n1, n2), n1, dev)
    post = _rand((n1, n2), 2, dev)
    for inverse in (False, True):
        _equal(nc.ntt_cols_cuda(a, inverse), nc.ntt_cols(a, inverse))
    _equal(nc.ntt_cols_cuda(a, post=post, pre=post),
           nc.ntt_cols(a, post=post, pre=post))


@pytest.mark.parametrize("q,tail", [(16, 0), (2, 14), (128, 896)])
def test_ntt_cols_dif_kernel(dev, q, tail):
    a = _rand((2, q, 64), q, dev)
    pre, post = _rand((q, 64), 3, dev), _rand((q + tail, 64), 4, dev)
    _equal(nc.ntt_cols_dif_cuda(a, tail), nc.ntt_cols_dif(a, tail))
    _equal(nc.ntt_cols_dif_cuda(a, tail, pre=pre, post=post),
           nc.ntt_cols_dif(a, tail, pre=pre, post=post))


def test_kernels_reject_bad_operands(dev):
    a = _rand((2, 16, 32), 5, dev)
    with pytest.raises(ValueError):
        nc.ntt_cols_cuda(a.transpose(1, 2))          # not contiguous
    with pytest.raises(ValueError):
        nc.ntt_cols_cuda(a, post=_rand((16, 16), 6, dev))   # wrong shape
    with pytest.raises(TypeError):
        pc.hash_leaves_cols_cuda(a[0].to(torch.int32))


def test_commit_on_card_matches_cpu(dev):
    v = np.random.default_rng(7).integers(0, P, size=(6, 1 << 9),
                                          dtype=np.uint64)
    card = PolynomialBatch.from_values(v, 3, False, 2, device=dev)
    cpu = PolynomialBatch.from_values(v, 3, False, 2, device="cpu")
    np.testing.assert_array_equal(card.leaves, cpu.leaves)
    np.testing.assert_array_equal(card.merkle_tree.cap.digests,
                                  cpu.merkle_tree.cap.digests)


def test_cpu_tensor_without_device_runs_on_card(dev):
    v = torch.from_numpy(np.random.default_rng(8).integers(
        0, P, size=(6, 1 << 9), dtype=np.uint64).view(np.int64))
    before = (pc.hash_leaves_cols_cuda.launches, nc.ntt_cols_cuda.launches)
    batch = PolynomialBatch.from_values(v, 3, False, 2)
    assert batch.leaves_dev.device.type == "cuda"
    assert pc.hash_leaves_cols_cuda.launches == before[0] + 1
    assert nc.ntt_cols_cuda.launches > before[1]
