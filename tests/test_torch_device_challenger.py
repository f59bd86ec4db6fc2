"""The port's device transcript (iop/challenger_torch.py:DeviceChallenger,
kernel K9's plain version hash/poseidon_cuda.py:sponge) on the CPU.

- Against the port's host ``Challenger`` on seeded random transcripts:
  single observations and bulk ones that cross the rate boundary, bulk
  absorbs that start from a pending buffer, caps (digest by digest),
  extension polynomials (coefficient by coefficient), draws that refill
  the outputs, extension draws with beta's powers, query indices, and a
  start from a host challenger mid-transcript; every draw and the state
  after (``sync_host``) equal.
- Against the JAX package's ``DeviceChallenger`` run eagerly (not jitted)
  on one short transcript: it is slow here, so the rest is held against
  the host challenger, which gives what it gives.
- The grind on the sponge (K8's plain version) against the host-state
  grind, with the witness landing in the last pending slot.
- ``sponge_lengths`` (the lengths the host keeps) against the plain
  version's buffering, and the plain version's permutation count.

Exact equality throughout."""
import copy

import numpy as np
import pytest
import torch

from plonky2_tpu.iop.challenger import Challenger as JaxChallenger
from plonky2_tpu_torch.field import extension as ext
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri.prover import fri_proof_of_work
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.hash import poseidon_cuda as pc
from plonky2_tpu_torch.iop.challenger import Challenger
from plonky2_tpu_torch.iop.challenger_torch import DeviceChallenger
from tests.test_torch_prover import P
from tests.test_torch_prover import one_torch_thread  # noqa: F401


def _vals(rng, k):
    v = rng.integers(0, P, size=k, dtype=np.uint64)
    if k:
        v[0] = [0, 1, P - 1][int(rng.integers(0, 3))]
    return v


def _run_script(rng, steps, dch, host):
    """The same seeded steps on the device challenger and the host one;
    every draw compared."""
    for _ in range(steps):
        k = int(rng.integers(0, 8))
        if k == 0:
            v = _vals(rng, 1)
            dch.observe_element(from_u64(v)[0])
            host.observe_element(v[0])
        elif k == 1:        # bulk, crossing the rate boundary
            v = _vals(rng, int(rng.integers(1, 20)))
            dch.observe_elements_array(from_u64(v))
            host.observe_elements(v)
        elif k == 2:        # a cap of 1-4 digests, column-major
            d = _vals(rng, 4 << int(rng.integers(0, 3))).reshape(-1, 4)
            dch.observe_cap_array(from_u64(d.T.copy()))
            host.observe_cap(d)
        elif k == 3:        # extension coefficients, as (2, m) in a wider row
            m = int(rng.integers(1, 6))
            c = _vals(rng, 2 * (m + 3)).reshape(2, m + 3)
            dch.observe_extension_elements(from_u64(c)[:, :m])
            host.observe_extension_elements(c[:, :m].T)
        elif k == 4:
            n = int(rng.integers(1, 12))
            assert list(to_u64(dch.get_n_challenges(n))) == \
                host.get_n_challenges(n)
        elif k == 5:
            arity = 1 << int(rng.integers(0, 4))
            beta, pw = dch.get_extension_challenge(powers=max(arity, 1))
            want = host.get_extension_challenge()
            assert tuple(to_u64(beta)) == want
            assert [tuple(c) for c in to_u64(pw).T] == ext.powers(want,
                                                                   arity)
        elif k == 6:
            n, mask = int(rng.integers(1, 30)), (1 << int(rng.integers(
                1, 20))) - 1
            draws, idx = dch.get_n_challenges(n, index_mask=mask)
            want = host.get_n_challenges(n)
            assert list(to_u64(draws)) == want
            assert idx.tolist() == [w & mask for w in want]
        else:
            assert int(to_u64(dch.get_challenge().reshape(1))[0]) == \
                host.get_challenge()


def _same_state(dch, host):
    mirror = Challenger()
    dch.sync_host(mirror)
    assert mirror.sponge_state == [int(x) for x in host.sponge_state]
    assert mirror.input_buffer == [int(x) for x in host.input_buffer]
    assert mirror.output_buffer == [int(x) for x in host.output_buffer]


@pytest.mark.parametrize("seed", range(4))
def test_device_challenger_matches_host_challenger(seed):
    rng = np.random.default_rng(seed)
    host = Challenger()
    if seed:    # a start mid-transcript: inputs pending or outputs left
        host.observe_elements(_vals(rng, 3 + 5 * seed))
        if seed % 2:
            host.get_n_challenges(1 + seed)
        dch = DeviceChallenger.from_host(host, "cpu")
    else:
        dch = DeviceChallenger("cpu")
    _run_script(rng, 10, dch, host)
    _same_state(dch, host)


def test_device_challenger_matches_jax_device_challenger():
    """One short transcript on the JAX package's DeviceChallenger, eager:
    a start with pending inputs, single observations to the rate
    boundary, a bulk absorb that peels from a pending buffer, one that
    starts on a block boundary, a cap, and draws (3 permutations)."""
    from plonky2_tpu.field import gf_jax as gfj
    from plonky2_tpu.iop.challenger_jax import DeviceChallenger as JaxDevice
    rng = np.random.default_rng(11)
    jhost, host = JaxChallenger(), Challenger()
    start = _vals(rng, 5)
    jhost.observe_elements(start)
    host.observe_elements(start)
    jdch = JaxDevice.from_host(jhost)
    dch = DeviceChallenger.from_host(host, "cpu")

    def pair(v):
        return gfj.from_u64(np.asarray(v, dtype=np.uint64))

    for x in _vals(rng, 2):
        lo, hi = pair([x])
        jdch.observe_element((lo[0], hi[0]))
        dch.observe_element(from_u64(np.array([x]))[0])
        host.observe_element(x)
    bulk = _vals(rng, 11)       # 1 to the boundary, 8, then 2 pending
    jdch.observe_elements_array(*pair(bulk))
    dch.observe_elements_array(from_u64(bulk))
    host.observe_elements(bulk)
    cap = _vals(rng, 8).reshape(2, 4)
    jdch.observe_cap_array(pair(cap.T), 2)
    dch.observe_cap_array(from_u64(cap.T.copy()))
    host.observe_cap(cap)
    got = dch.get_n_challenges(3).tolist()
    want = [int(gfj.to_u64((np.asarray(c[0]), np.asarray(c[1]))))
            for c in jdch.get_n_challenges(3)]
    assert [x & ((1 << 64) - 1) for x in got] == want
    want_host = host.get_n_challenges(3)
    assert want == want_host


@pytest.mark.parametrize("pending,bits", [(0, 4), (3, 1), (7, 6), (5, 0)])
def test_grind_on_the_sponge_matches_the_host_grind(pending, bits):
    """The witness lands in pending slot `pending` (at 7 it fills the
    buffer, and the next launch duplexes first); the response and the
    query indices after it equal the host challenger's."""
    rng = np.random.default_rng(pending)
    host = Challenger()
    host.observe_elements(_vals(rng, 16 + pending))
    dch = DeviceChallenger.from_host(host, "cpu")
    config = type("C", (), {"proof_of_work_bits": bits})
    witness = dch.grind(bits)
    assert dch.n_in == pending + 1
    want = fri_proof_of_work(copy.deepcopy(host), config, "cpu")
    assert int(witness[0]) == want
    host.observe_element(want)
    draws, idx = dch.get_n_challenges(9, index_mask=(1 << 13) - 1)
    host_draws = host.get_n_challenges(9)
    assert list(to_u64(draws)) == host_draws
    assert host_draws[0] < 1 << (64 - bits) or bits == 0
    assert idx.tolist() == [d % (1 << 13) for d in host_draws]
    _same_state(dch, host)


def test_sponge_lengths_follow_the_plain_sponge(monkeypatch):
    """The lengths the host keeps after a launch, and the permutations,
    equal what the plain version does, over pending counts, words and
    draws (the permutation counted, not run)."""
    count = [0]

    def fake(state):
        count[0] += 1
        return state + 1
    monkeypatch.setattr(pos, "poseidon_fast_t", fake)
    for n_in in range(9):
        for n_out in (0, 3, 8):
            for n_words in (0, 1, 7 - min(n_in, 7), 8, 17):
                for n_draws in (0, 1, 9):
                    buf = torch.zeros(pc.SPONGE_WORDS, dtype=torch.int64)
                    src = torch.zeros((1, n_words), dtype=torch.int64)
                    count[0] = 0
                    pc.sponge(buf, n_in, n_out, src if n_words else None,
                              n_draws)
                    lengths = pc.sponge_lengths(n_in, n_out, n_words,
                                                n_draws)
                    assert lengths[2] == count[0]
                    assert 0 <= lengths[0] < 8 and 0 <= lengths[1] <= 8


def test_sponge_refuses_what_it_cannot_take():
    buf = torch.zeros(pc.SPONGE_WORDS, dtype=torch.int64)
    for kwargs in ({"n_in": 9}, {"n_out": 9}, {"n_draws": 1, "arity": 4},
                   {"src": torch.zeros((5, 2), dtype=torch.int64)},
                   {"src": torch.zeros((2, 4), dtype=torch.int64)[:, ::2]},
                   {"index_mask": -1}):
        args = {"n_in": 0, "n_out": 0, "src": None, "n_draws": 2,
                **kwargs}
        with pytest.raises(ValueError):
            pc.sponge_cuda(buf, **args)
    with pytest.raises(ValueError):
        pc.sponge_cuda(buf[:12], 0, 0)
    with pytest.raises(ValueError):
        pc.pow_grind_sponge_cuda(buf, 8, 4)
    host = Challenger()
    host.observe_elements([1, 2, 3])
    host.output_buffer = [5]
    with pytest.raises(ValueError):
        DeviceChallenger.from_host(host, "cpu")
