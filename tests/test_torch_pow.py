"""Kernel K8's plain version (hash/poseidon_cuda.py:pow_grind, the FRI
proof-of-work grind on poseidon_fast_t) on the CPU.

It finds what the host grind it replaces found (numpy batches through
hash/poseidon.py:poseidon, the smallest passing witness) at 0, 1, 2, 4, 8
and 12 bits at every witness position 0-7, from start offsets on and
across a batch's edge, and what the JAX package's
plonky2_tpu/fri/prover.py:fri_proof_of_work finds from the same
transcript, which then stays equal on both sides.  A response is below
2^(64 - bits) as an unsigned number (0 bits: every witness passes)."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from plonky2_tpu.fri.prover import fri_proof_of_work as jax_pow
from plonky2_tpu.iop.challenger import Challenger as JaxChallenger
from plonky2_tpu_torch.field.convert import from_u64
from plonky2_tpu_torch.fri.prover import fri_proof_of_work
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.hash import poseidon_cuda as pc
from plonky2_tpu_torch.iop.challenger import Challenger
from tests.test_torch_prover import P
from tests.test_torch_prover import one_torch_thread  # noqa: F401

BITS = (0, 1, 2, 4, 8, 12)


def numpy_grind(base, word: int, bits: int, start: int = 0,
                batch: int = 512) -> int:
    """The host grind K8 replaced: numpy batches of candidates through
    hash/poseidon.py:poseidon, the first whose word 7 is below the bound."""
    bound = 1 << (64 - bits)
    for s in range(start, 1 << 40, batch):
        states = np.broadcast_to(np.asarray(base, dtype=np.uint64),
                                 (batch, pos.WIDTH)).copy()
        states[:, word] = np.arange(s, s + batch, dtype=np.uint64)
        ok = np.flatnonzero(pos.poseidon(states)[:, pos.SPONGE_RATE - 1]
                            < np.uint64(bound)) if bits else [0]
        if len(ok):
            return s + int(ok[0])
    raise AssertionError("no witness")


def _base(seed: int) -> np.ndarray:
    base = np.random.default_rng(seed).integers(0, P, size=12,
                                                dtype=np.uint64)
    base[seed % 12] = P - 1
    return base


@pytest.mark.parametrize("word", range(8))
def test_pow_grind_finds_the_host_grinds_witness(word):
    """Every position, every bit count; at 1-4 bits many candidates of a
    batch pass and the smallest is taken."""
    base = _base(word)
    t = from_u64(base)
    for bits in BITS:
        batch = 1024 if bits > 8 else 64
        got = pc.pow_grind(t, word, bits, batch=batch)
        assert got == numpy_grind(base, word, bits), bits
        state = [int(x) for x in base]
        state[word] = got
        response = pos.permute_ints(state)[pos.SPONGE_RATE - 1]
        assert bits == 0 or response < 1 << (64 - bits)
    # the wrapper takes its plain version on a CPU tensor
    assert pc.pow_grind_cuda(t, word, 4) == numpy_grind(base, word, 4)


@pytest.mark.parametrize("start", [0, 61, 63, 64, 65, 200])
def test_pow_grind_from_start_offsets(start):
    """From `start` on, with batches of 64: the first batch begins off its
    edge, and a witness may lie in the next batch."""
    base = _base(40 + start)
    t = from_u64(base)
    for bits in (0, 3, 6):
        want = numpy_grind(base, 3, bits, start=start, batch=16)
        assert pc.pow_grind(t, 3, bits, start=start, batch=64) == want
    assert pc.pow_grind_cuda(t, 3, 0, start=start) == start


def test_pow_grind_raises_past_its_limit():
    base = from_u64(_base(7))
    want = numpy_grind(_base(7), 5, 10)
    assert pc.pow_grind(base, 5, 10, limit=want + 1) == want
    with pytest.raises(RuntimeError, match="no witness"):
        pc.pow_grind(base, 5, 10, start=0, limit=want)
    for word, bits, start, limit in ((12, 4, 0, 8), (-1, 4, 0, 8),
                                     (0, 65, 0, 8), (0, 4, 9, 8),
                                     (0, 4, 0, pc.POW_LIMIT + 1)):
        with pytest.raises(ValueError):
            pc.pow_grind_cuda(base, word, bits, start, limit)
    with pytest.raises(ValueError):
        pc.pow_grind_cuda(base[:11], 0, 4)
    with pytest.raises(TypeError):
        pc.pow_grind_cuda(base.to(torch.int32), 0, 4)


@pytest.mark.parametrize("bits,pre", [(0, 7), (1, 9), (2, 2), (4, 12),
                                      (8, 0), (12, 5)])
def test_fri_proof_of_work_matches_jax(bits, pre):
    """From one transcript (`pre` elements observed after a cap-sized
    prefix, so pre % 8 pending), the port's grind on the CPU finds the JAX
    package's witness, and both transcripts stay equal."""
    config = SimpleNamespace(proof_of_work_bits=bits)
    ours, ref = Challenger(), JaxChallenger()
    elems = [int(x) for x in _base(bits)] + list(range(pre))
    for ch in (ours, ref):
        ch.observe_elements(elems + [P - 1, 2**32])
    before = copy.deepcopy(ours)
    assert fri_proof_of_work(ours, config, "cpu") == jax_pow(ref, config)
    assert ours.get_n_challenges(5) == ref.get_n_challenges(5)
    # the same witness from the duplex state directly
    w = pc.pow_grind(from_u64(np.array(before.duplex_input_state(),
                                       dtype=np.uint64)),
                     len(before.input_buffer), bits)
    before.observe_element(w)
    assert bits == 0 or before.get_challenge() < 1 << (64 - bits)
