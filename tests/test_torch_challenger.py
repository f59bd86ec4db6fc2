"""The port's transcript and host hashing against the JAX package.

- ``Challenger`` against the JAX ``Challenger`` on seeded random sequences
  of observations and draws: partial input buffers, full ones, draws that
  empty the output buffer, extension draws, caps and hashes.
- The numpy batch permutation, ``hash_n_to_m_no_pad``, ``hash_no_pad`` and
  the scalar permutation ``permute_ints``.
- The host extension arithmetic (field/extension.py) and the device one
  (field/gf2.py) at the boundary values 0, 1, 2^32 - 1, 2^32, p - 1.
- The proof-of-work witness from the same transcript state.

Exact equality throughout."""
import numpy as np
import pytest

from plonky2_tpu.field import extension as jext
from plonky2_tpu.field import gf2_jax as jgf2
from plonky2_tpu.field import gf_jax as gfj
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.hash import poseidon as jpos
from plonky2_tpu.iop.challenger import Challenger as JaxChallenger
from plonky2_tpu_torch.field import extension as ext
from plonky2_tpu_torch.field import gf
from plonky2_tpu_torch.field import gf2
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.iop.challenger import Challenger
from tests.test_torch_prover import one_torch_thread  # noqa: F401

P = jgl.P
BOUNDARY = [0, 1, (1 << 32) - 1, 1 << 32, P - 1]


def _random_script(rng, steps: int):
    """A seeded sequence of (operation, argument) transcript steps."""
    ops = []
    for _ in range(steps):
        k = int(rng.integers(0, 9))
        vals = rng.integers(0, P, size=16, dtype=np.uint64)
        if k == 0:
            ops.append(("observe_element", int(vals[0])))
        elif k == 1:
            ops.append(("observe_elements",
                        vals[:int(rng.integers(0, 17))]))
        elif k == 2:
            ops.append(("observe_hash", vals[:4]))
        elif k == 3:
            ops.append(("observe_cap",
                        vals[:4 << int(rng.integers(0, 3))].reshape(-1, 4)))
        elif k == 4:
            ops.append(("observe_extension_element",
                        (int(vals[0]), int(vals[1]))))
        elif k == 5:
            ops.append(("observe_extension_elements",
                        vals[:2 * int(rng.integers(0, 6))].reshape(-1, 2)))
        elif k == 6:
            ops.append(("get_n_challenges", int(rng.integers(1, 12))))
        elif k == 7:
            ops.append(("get_extension_challenge", None))
        else:
            ops.append(("get_hash", None))
    return ops


def _run(ch, ops):
    out = []
    for name, arg in ops:
        r = getattr(ch, name)() if arg is None else getattr(ch, name)(arg)
        if r is not None:
            out.append([int(x) for x in np.asarray(r, dtype=np.uint64)
                        .reshape(-1)])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_challenger_matches_jax_on_random_transcripts(seed):
    ops = _random_script(np.random.default_rng(seed), 60)
    ours, ref = Challenger(), JaxChallenger()
    assert _run(ours, ops) == _run(ref, ops)
    assert ours.sponge_state == [int(x) for x in ref.sponge_state]
    assert ours.input_buffer == ref.input_buffer
    assert ours.output_buffer == [int(x) for x in ref.output_buffer]
    assert ours.get_n_extension_challenges(3) == \
        ref.get_n_extension_challenges(3)


def test_challenger_buffer_edges():
    """A draw right after exactly 8 observations (the duplexing already
    ran), after 7 (pending inputs), and 9 draws in a row (the output
    buffer empties and refills)."""
    for n_obs in (0, 7, 8, 9, 16):
        ours, ref = Challenger(), JaxChallenger()
        vals = list(range(1, n_obs + 1)) + [P - 1]
        ours.observe_elements(vals)
        ref.observe_elements(vals)
        assert ours.duplex_input_state()[:len(ref.input_buffer)] == \
            ref.input_buffer
        assert ours.get_n_challenges(9) == ref.get_n_challenges(9)
        assert ours.get_extension_challenge() == \
            ref.get_extension_challenge()


def test_observe_extension_element_rejects_a_base_element():
    with pytest.raises(ValueError):
        Challenger().observe_extension_element([1, 2, 3])


@pytest.mark.parametrize("n", [0, 1, 4, 7, 8, 9, 16, 23])
def test_hash_no_pad_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, P, size=n, dtype=np.uint64)
    x[:min(n, 5)] = BOUNDARY[:min(n, 5)]
    np.testing.assert_array_equal(pos.hash_no_pad(x), jpos.hash_no_pad(x))
    for m in (1, 4, 8, 9, 20):
        np.testing.assert_array_equal(pos.hash_n_to_m_no_pad(x, m),
                                      jpos.hash_n_to_m_no_pad(x, m))


def test_permutations_match_jax():
    rng = np.random.default_rng(5)
    states = rng.integers(0, P, size=(33, 12), dtype=np.uint64)
    states[0] = BOUNDARY + BOUNDARY + [0, P - 1]
    np.testing.assert_array_equal(pos.poseidon(states), jpos.poseidon(states))
    for s in states[:6]:
        s = [int(x) for x in s]
        assert pos.permute_ints(s) == jpos.poseidon_ints(s)


def test_host_extension_matches_jax():
    vals = [(a, b) for a in BOUNDARY for b in BOUNDARY]
    rng = np.random.default_rng(9)
    vals += [tuple(int(x) for x in rng.integers(0, P, 2, dtype=np.uint64))
             for _ in range(8)]
    for a in vals:
        assert ext.s_inv(a) == jext.s_inv(a)
        assert ext.s_exp(a, 1 << 18) == jext.s_exp(a, 1 << 18)
        assert ext.s_exp(a, 12345) == jext.s_exp(a, 12345)
        for b in vals[::3]:
            assert ext.s_mul(a, b) == jext.s_mul(a, b)
            assert ext.s_add(a, b) == jext.s_add(a, b)
            assert ext.s_sub(a, b) == jext.s_sub(a, b)
    base = vals[-1]
    want = jext.powers(np.array(base, dtype=np.uint64), 37)
    assert ext.powers(base, 37) == [tuple(int(x) for x in r) for r in want]
    assert ext.powers(base, 0) == []


def _pairs(rng, n):
    """(n, 2) extension values: every boundary pair, then random ones."""
    b = np.array([(x, y) for x in BOUNDARY for y in BOUNDARY],
                 dtype=np.uint64)
    r = rng.integers(0, P, size=(n - len(b), 2), dtype=np.uint64)
    return np.concatenate([b, r])


def test_gf2_matches_jax_at_boundary_values():
    rng = np.random.default_rng(11)
    a, b = _pairs(rng, 64), _pairs(rng, 64)[::-1].copy()
    s = rng.integers(0, P, size=64, dtype=np.uint64)
    s[:5] = BOUNDARY
    t = lambda x: (from_u64(x[:, 0]), from_u64(x[:, 1]))  # noqa: E731
    j = lambda x: (gfj.from_u64(x[:, 0]), gfj.from_u64(x[:, 1]))  # noqa: E731

    def same(ours, ref):
        for c in range(2):
            np.testing.assert_array_equal(to_u64(ours[c]),
                                          gfj.to_u64(ref[c]))

    same(gf2.add2(t(a), t(b)), jgf2.add2(j(a), j(b)))
    same(gf2.sub2(t(a), t(b)), jgf2.sub2(j(a), j(b)))
    same(gf2.mul2(t(a), t(b)), jgf2.mul2(j(a), j(b)))
    same(gf2.mul2_base(t(a), from_u64(s)),
         jgf2.mul2_base(j(a), gfj.from_u64(s)))
    same(gf2.inverse2(t(a)), jgf2.inverse2(j(a)))
    same(gf2.sum2(t(a), 0), jgf2.sum2(j(a), 0))
    # the batch inversion of the norms gives the Fermat inverses
    from plonky2_tpu_torch.ops.partial_products import inverse_rows
    norm_inv = inverse_rows(gf2.norm2(t(a)).reshape(8, 8)).reshape(64)
    same(gf2.inverse2(t(a), norm_inverse=norm_inv), jgf2.inverse2(j(a)))


def test_modsum_matches_python_sums():
    rng = np.random.default_rng(12)
    x = rng.integers(0, P, size=(3, 1000), dtype=np.uint64)
    x[0] = P - 1
    x[1, :5] = BOUNDARY
    got = to_u64(gf.modsum(from_u64(x), -1))
    assert [int(v) for v in got] == [sum(int(v) for v in r) % P for r in x]
    assert int(to_u64(gf.modsum(from_u64(x[:, :0]), -1))[0]) == 0


@pytest.mark.parametrize("pre", [0, 3, 7, 8])
def test_proof_of_work_matches_jax(pre):
    """From the same transcript state (`pre` elements pending), the port
    finds JAX's witness and both transcripts stay equal (the port's grind
    on the CPU: K8's plain version)."""
    from types import SimpleNamespace

    from plonky2_tpu.fri.prover import fri_proof_of_work as jax_pow
    from plonky2_tpu_torch.fri.prover import fri_proof_of_work
    config = SimpleNamespace(proof_of_work_bits=10)
    ours, ref = Challenger(), JaxChallenger()
    for ch in (ours, ref):
        ch.observe_elements(list(range(100, 100 + 11 + pre)))
    assert fri_proof_of_work(ours, config, "cpu") == jax_pow(ref, config)
    assert ours.get_n_challenges(5) == ref.get_n_challenges(5)
