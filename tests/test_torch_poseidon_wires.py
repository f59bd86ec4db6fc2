"""The Poseidon gate's witness wave (hash/poseidon_wires.py, the plain
version of kernel K7) against the JAX package, on the CPU.

``poseidon_wire_batch`` equals JAX's ``poseidon_wire_batch``
(plonky2_tpu/hash/poseidon_wires_jax.py) and the port's numpy
``PoseidonGenerator.run_batch``, exactly, for G in {1, 7, 64} rows of
random values and of the boundary values 0, 1, 2^32 - 1, 2^32 and p - 1,
under both swap settings.  ``poseidon_wires`` (gather, wave, scatter)
equals a reference indexed by hand, and flags a swap wire of 2; a run of
dependent waves (``poseidon_wires_waves``, K7's plain version, and its
wrapper on the CPU) equals the waves computed one by one."""
import jax
import numpy as np
import pytest
import torch

from plonky2_tpu.field import gf_jax as jgf
from plonky2_tpu.hash.poseidon_wires_jax import \
    poseidon_wire_batch as jax_wire_batch
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.gates.poseidon_gate import PoseidonGenerator
from plonky2_tpu_torch.hash import poseidon_cuda as pc
from plonky2_tpu_torch.hash import poseidon_wires as pw
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import P

# compiled once for each G (the swap settings share it)
jax_wires = jax.jit(jax_wire_batch)
BOUNDARY = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - 1], dtype=np.uint64)


def wave_inputs(G: int, swap, seed: int) -> np.ndarray:
    """(G, 13) uint64: random inputs, boundary values in the odd rows, and
    the swap wire (0, 1, or per row at random when None)."""
    rng = np.random.default_rng(seed)
    dep = rng.integers(0, P, size=(G, 13), dtype=np.uint64)
    dep[1::2, :12] = BOUNDARY[rng.integers(0, 5, size=(G // 2, 12))]
    dep[:, 12] = rng.integers(0, 2, size=G) if swap is None else swap
    return dep


@pytest.mark.parametrize("G", [1, 7, 64])
@pytest.mark.parametrize("swap", [0, 1, None])
def test_wire_batch_equals_jax_and_host(G, swap):
    dep = wave_inputs(G, swap, G + 3 * (swap or 0))
    got = to_u64(pw.poseidon_wire_batch(from_u64(dep)))
    assert got.shape == (pw.NUM_OUTPUT_WIRES, G) == (122, G)
    want = jgf.to_u64(tuple(np.asarray(x) for x in
                            jax_wires(jgf.from_u64(dep))))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.T, PoseidonGenerator.run_batch(None,
                                                                     dep))
    assert (got < np.uint64(P)).all()


def test_gather_wave_scatter_equals_hand_indexed():
    """K7's plain version reads and writes the slot buffer where the index
    arrays say, leaves every other slot alone, and flags a bad swap."""
    rng = np.random.default_rng(11)
    G, n_slots = 9, 4000
    buf = rng.integers(0, P, size=n_slots, dtype=np.uint64)
    slots = rng.permutation(n_slots)[:G * (13 + 122)].astype(np.int32)
    dep_idx = slots[:13 * G].reshape(13, G)
    out_idx = slots[13 * G:].reshape(122, G)
    buf[dep_idx[12]] = rng.integers(0, 2, size=G)
    buf[dep_idx[:12, :4]] = BOUNDARY[rng.integers(0, 5, size=(12, 4))]
    want = buf.copy()
    for g in range(G):
        row = np.array([buf[dep_idx[k, g]] for k in range(13)],
                       dtype=np.uint64)
        wires = PoseidonGenerator.run_batch(None, row[None])[0]
        for j in range(122):
            want[out_idx[j, g]] = wires[j]
    values = from_u64(buf)
    err = torch.zeros(1, dtype=torch.int32)
    pw.poseidon_wires(values, torch.from_numpy(dep_idx),
                      torch.from_numpy(out_idx), err)
    np.testing.assert_array_equal(to_u64(values), want)
    assert int(err[0]) == 0

    buf[dep_idx[12, 3]] = 2
    values = from_u64(buf)
    pw.poseidon_wires(values, torch.from_numpy(dep_idx),
                      torch.from_numpy(out_idx), err)
    assert int(err[0]) != 0


def chain(rng, sizes):
    """chip_smoke.py:wave_chain on the CPU: (buf uint64, dep_idx, out_idx
    as int32 numpy arrays, offsets)."""
    from chip_smoke import wave_chain
    values, dep, out, offsets = wave_chain(rng, sizes, "cpu")
    return to_u64(values), dep.numpy(), out.numpy(), offsets


def test_waves_run_equals_waves_one_by_one():
    """A chain of six dependent waves: the run (the wrapper on a CPU
    tensor takes K7's plain version) equals the numpy generator's waves
    one after the other, and the plain wave run one by one; a swap wire
    of 2 in a later wave sets the flag."""
    rng = np.random.default_rng(21)
    buf, dep, out, offsets = chain(rng, (16, 8, 4, 2, 1, 1))
    want = buf.copy()
    for a, b in zip(offsets, offsets[1:]):
        want[out[:, a:b]] = PoseidonGenerator.run_batch(
            None, want[dep[:, a:b]].T).T
    dep_t, out_t = torch.from_numpy(dep), torch.from_numpy(out)
    values, err = from_u64(buf), torch.zeros(1, dtype=torch.int32)
    pc.poseidon_wires_waves_cuda(values, dep_t, out_t, offsets, err)
    np.testing.assert_array_equal(to_u64(values), want)
    one_by_one = from_u64(buf)
    for a, b in zip(offsets, offsets[1:]):
        pw.poseidon_wires(one_by_one, dep_t[:, a:b], out_t[:, a:b], err)
    np.testing.assert_array_equal(to_u64(one_by_one), want)
    assert int(err[0]) == 0
    # a run of the middle waves reads what the first wave wrote
    part = from_u64(buf)
    pw.poseidon_wires(part, dep_t[:, :16], out_t[:, :16], err)
    pc.poseidon_wires_waves_cuda(part, dep_t, out_t, offsets[1:4], err)
    assert (to_u64(part)[out[:, :offsets[3]]] == want[out[:, :offsets[3]]]
            ).all()
    buf[dep[12, offsets[3]]] = 2
    pw.poseidon_wires_waves(from_u64(buf), dep_t, out_t, offsets, err)
    assert int(err[0]) != 0


def test_waves_wrapper_rejects_bad_offsets():
    rng = np.random.default_rng(3)
    buf, dep, out, _ = chain(rng, (4, 2))
    args = (from_u64(buf), torch.from_numpy(dep), torch.from_numpy(out))
    err = torch.zeros(1, dtype=torch.int32)
    for offsets in ((0,), (0, 7), (2, 1, 6), (-1, 6)):
        with pytest.raises(ValueError, match="offsets"):
            pc.poseidon_wires_waves_cuda(*args, offsets, err)
