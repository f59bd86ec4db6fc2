"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where torch sees no CUDA device.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports jax.)"""
import os

import numpy as np
import pytest
import torch

from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.field.goldilocks import P
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.hash import poseidon_cuda as pc
from plonky2_tpu_torch.ops import ntt as tntt
from plonky2_tpu_torch.ops import ntt_cuda as nc
from plonky2_tpu_torch.plonk import constraint_program as cp
from plonky2_tpu_torch.plonk import constraint_program_cuda as cpc

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


@pytest.mark.parametrize("L", [1, 5, 7, 8, 9, 12, 234, 2481])
def test_hash_leaves_kernel(dev, L):
    """K1 on the fast schedule, partial last absorb blocks included; the
    first 256 leaves hold boundary values only."""
    leaves = _rand((L, 1024), L, dev)
    leaves[:, :256] = from_u64(BOUNDARY[np.random.default_rng(L).integers(
        0, 5, size=(L, 256))], dev)
    before = pc.hash_leaves_cols_cuda.launches
    want = pos.hash_leaves_cols(leaves)
    _equal(pc.hash_leaves_cols_cuda(leaves), want)
    assert pc.hash_leaves_cols_cuda.launches == before + 1
    _equal(pos.hash_leaves_cols(leaves[:, :64].cpu()), want[:, :64].cpu())


def test_compress_level_kernel(dev):
    level = _rand((4, 2048), 1, dev)
    level[:, :512] = from_u64(BOUNDARY[np.random.default_rng(1).integers(
        0, 5, size=(4, 512))], dev)
    _equal(pc.compress_level_cuda(level), pc.compress_level(level))


@pytest.mark.parametrize("m0,n_levels,boundary", [
    (1 << 14, 11, False), (1 << 14, 15, True), (16, 5, False), (16, 1, True),
    (1 << 16, 13, False)])
def test_compress_tail_kernel(dev, m0, n_levels, boundary):
    """K2's narrow top in one launch against its plain version: from 2^14
    parents to a cap of 16 and to one root, a 2^5-leaf tree from its
    digests, and from 2^16 parents (more nodes than the grid holds at
    once); boundary values in the inputs where marked."""
    level = _rand((4, 2 * m0), m0 + n_levels, dev)
    if boundary:
        level[:, :m0] = from_u64(BOUNDARY[np.random.default_rng(m0).integers(
            0, 5, size=(4, m0))], dev)
    before = pc.compress_tail_cuda.launches
    got = pc.compress_tail_cuda(level, n_levels)
    assert pc.compress_tail_cuda.launches == before + 1
    want = pc.compress_tail(level, n_levels)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        _equal(g, w)


def test_digest_levels_wide_then_tail(dev):
    """A tree of 2^16 leaves: one wide level (2^15 parents), then the
    tail, equal to the per-level kernel's levels."""
    from plonky2_tpu_torch.hash import merkle_torch
    leaves = _rand((12, 1 << 16), 16, dev)
    before = (pc.compress_level_cuda.launches, pc.compress_tail_cuda.launches)
    levels = merkle_torch.build_digest_levels(leaves, 4)
    assert (pc.compress_level_cuda.launches, pc.compress_tail_cuda.launches) \
        == (before[0] + 1, before[1] + 1)
    x = levels[0]
    for got in levels[1:]:
        x = pc.compress_level_cuda(x)
        _equal(got, x)


@pytest.mark.parametrize("n1,n2", [(16, 128), (512, 64), (2048, 8),
                                   (8192, 4)])
def test_ntt_cols_kernel(dev, n1, n2):
    a = _rand((2, n1, n2), n1, dev)
    post = _rand((n1, n2), 2, dev)
    for inverse in (False, True):
        _equal(nc.ntt_cols_cuda(a, inverse), nc.ntt_cols(a, inverse))
    _equal(nc.ntt_cols_cuda(a, post=post, pre=post),
           nc.ntt_cols(a, post=post, pre=post))


@pytest.mark.parametrize("q,tail", [(16, 0), (2, 14), (128, 896),
                                    (100, 924), (3, 13)])
def test_ntt_cols_dif_kernel(dev, q, tail):
    a = _rand((2, q, 64), q, dev)
    pre, post = _rand((q, 64), 3, dev), _rand((q + tail, 64), 4, dev)
    _equal(nc.ntt_cols_dif_cuda(a, tail), nc.ntt_cols_dif(a, tail))
    _equal(nc.ntt_cols_dif_cuda(a, tail, pre=pre, post=post),
           nc.ntt_cols_dif(a, tail, pre=pre, post=post))


BOUNDARY = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - 1], dtype=np.uint64)


@pytest.mark.parametrize("B,n1,n2", [(2, 16, 8), (3, 2, 64), (2, 1, 8),
                                     (2, 512, 512), (1, 1024, 2048),
                                     (1, 4, 8192)])
def test_ntt_rows_kernel(dev, B, n1, n2):
    """K3's row form (stored transposed) against its plain version and the
    column form on the transposed input; boundary values in the first
    batch entry."""
    a = _rand((B, n1, n2), n1 + n2, dev)
    a[0] = from_u64(BOUNDARY[np.random.default_rng(n2).integers(
        0, 5, size=(n1, n2))], dev)
    post = _rand((n2, n1), 5, dev)
    before = nc.ntt_rows_cuda.launches
    for inverse in (False, True):
        _equal(nc.ntt_rows_cuda(a, inverse), nc.ntt_rows(a, inverse))
    _equal(nc.ntt_rows_cuda(a, True, post), nc.ntt_rows(a, True, post))
    assert nc.ntt_rows_cuda.launches == before + 3
    _equal(nc.ntt_rows_cuda(a), nc.ntt_cols_cuda(a.transpose(1, 2)
                                                 .contiguous()))


@pytest.mark.parametrize("B,n1,n2", [(2, 16, 8), (3, 2, 64),
                                     (2, 1024, 2048), (1, 2, 8192)])
def test_ntt_rows_dif_kernel_in_place(dev, B, n1, n2):
    """K5's row form in place on its input."""
    a = _rand((B, n1, n2), n1 * n2, dev)
    a[0] = from_u64(BOUNDARY[np.random.default_rng(n1).integers(
        0, 5, size=(n1, n2))], dev)
    want = nc.ntt_rows_dif(a)
    before = nc.ntt_rows_dif_cuda.launches
    assert nc.ntt_rows_dif_cuda(a) is a
    assert nc.ntt_rows_dif_cuda.launches == before + 1
    _equal(a, want)


def test_ntt_row_forms_refuse_what_they_cannot_take(dev):
    """No fallback: a shape a row form cannot take raises."""
    long_rows = torch.zeros((1, 2, 2 * nc.MAX_N2_ROWS), dtype=torch.int64,
                            device=dev)
    for fn in (nc.ntt_rows_cuda, nc.ntt_rows_dif_cuda):
        with pytest.raises(ValueError, match="at most"):
            fn(long_rows)
        with pytest.raises(ValueError):
            fn(_rand((2, 8, 8), 8, dev).transpose(1, 2))   # not contiguous


@pytest.mark.parametrize("log_m,r,B", [(9, 1, 1), (11, 2, 3), (13, 3, 1),
                                       (13, 1, 3)])
def test_four_step_schedules_on_card_match_cpu(dev, log_m, r, B):
    """The transpose-free schedules on the card against the CPU (plain)."""
    from plonky2_tpu_torch.parallel import four_step
    m = 1 << log_m
    v = _rand((B, m), log_m, "cpu")
    q = m >> r
    for fn in (lambda x: four_step.batched_four_step_ntt(x),
               lambda x: four_step.batched_four_step_ntt(x, True),
               lambda x: four_step.batched_four_step_zero_tail_ntt(
                   x[:, :q].contiguous(), r),
               lambda x: four_step.batched_four_step_zero_tail_bitrev(
                   x[:, :q].contiguous(), r)):
        _equal(fn(v.to(dev)), fn(v))


FLAGSHIP_NPZ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "plonky2_tpu_torch", "plonk", "programs",
    "hash_tree_wide_ecc.npz")


@pytest.mark.parametrize("q,r,n2", [(16, 3, 128), (1, 3, 64), (128, 3, 256),
                                    (64, 0, 64), (512, 1, 16)])
def test_ntt_cols_zero_tail_kernel(dev, q, r, n2):
    a = _rand((2, q, n2), q + r, dev)
    a[0] = from_u64(BOUNDARY[np.random.default_rng(q).integers(
        0, 5, size=(q, n2))], dev)
    pre, post = _rand((q, n2), 3, dev), _rand((q << r, n2), 4, dev)
    before = nc.ntt_cols_zero_tail_cuda.launches
    _equal(nc.ntt_cols_zero_tail_cuda(a, r), nc.ntt_cols_zero_tail(a, r))
    _equal(nc.ntt_cols_zero_tail_cuda(a, r, pre=pre, post=post),
           nc.ntt_cols_zero_tail(a, r, pre=pre, post=post))
    assert nc.ntt_cols_zero_tail_cuda.launches == before + 2


def test_natural_lde_is_bitrev_lde_reordered(dev):
    """K4's natural-order LDE against K5's leaf-order LDE."""
    from plonky2_tpu_torch.utils.bits import bit_reverse_indices
    c = _rand((3, 1 << 12), 9, dev)
    nat = tntt.lde_coset_ntt(c, 3)
    perm = torch.from_numpy(bit_reverse_indices(1 << 15)).to(dev)
    _equal(nat, tntt.lde_coset_ntt_bitrev(c, 3)[:, perm])


@pytest.mark.parametrize("seed,W", [(0, 8), (1, 16), (2, 32)])
def test_constraint_program_kernel_random(dev, seed, W):
    rng = np.random.default_rng(seed)
    prog = cp.random_program(rng, wave_width=W, n_regs=3 * W)
    assert cp.in_wave_reuse(prog)
    inputs = _rand((prog.n_inputs, 1000), seed, dev)
    inputs[:, :100] = from_u64(BOUNDARY[rng.integers(
        0, 5, size=(prog.n_inputs, 100))], dev)
    bank = from_u64(prog.scalar_bank([5, P - 2]), dev)
    before = cpc.run_program_cuda.launches
    _equal(cpc.run_program_cuda(prog, inputs, bank),
           prog.run_plain(inputs, bank))
    assert cpc.run_program_cuda.launches == before + 1


def test_constraint_program_kernel_flagship(dev):
    """K6 on the flagship program's linear form: full inputs and the rows
    it reads only; a ragged lane count; boundary values in the first 1024
    lanes."""
    prog, _ = cp.load(FLAGSHIP_NPZ)
    lin = cp.linearize(prog)
    rng = np.random.default_rng(11)
    inputs = _rand((prog.n_inputs, 4000), 11, dev)
    inputs[:, :1024] = from_u64(BOUNDARY[rng.integers(
        0, 5, size=(prog.n_inputs, 1024))], dev)
    bank = from_u64(prog.scalar_bank(
        [int(x) for x in rng.integers(0, P, size=prog.n_scalar_inputs,
                                      dtype=np.uint64)]), dev)
    want = prog.run_plain(inputs, bank)
    _equal(cpc.run_program_cuda(prog, inputs, bank), want)
    rows = torch.from_numpy(lin.input_rows.astype(np.int64)).to(dev)
    _equal(cpc.run_program_cuda(prog, inputs[rows].contiguous(), bank), want)
    _equal(cp.run_plain_linear(lin, inputs, bank), want)
    with pytest.raises(ValueError):        # a register file is not taken
        cpc.run_program_cuda(prog, torch.zeros(
            (prog.n_regs, 64), dtype=torch.int64, device=dev), bank)


@pytest.mark.parametrize("lanes", [100, 5000, 40000])
def test_constraint_program_kernel_spilling(dev, lanes):
    """K6 on a program of more slots than shared memory holds at 32 lanes
    (constraint_program.py:wide_program): the busiest slots in shared
    memory, the rest in device scratch; lane counts below, near and far
    above the lanes resident on the card (a block walks several tiles)."""
    prog = cp.wide_program()
    lin = cp.linearize(prog)
    form = cpc.k6_form(lin.n_slots, len(prog.bank_sids))
    assert lin.n_slots >= 1200 and form.n_spilled > 0
    rng = np.random.default_rng(lanes)
    inputs = _rand((prog.n_inputs, lanes), lanes, dev)
    inputs[:, :50] = from_u64(BOUNDARY[rng.integers(
        0, 5, size=(prog.n_inputs, 50))], dev)
    bank = from_u64(prog.scalar_bank([7, 11, P - 1, 2]), dev)
    before = cpc.run_program_cuda.launches
    _equal(cpc.run_program_cuda(prog, inputs, bank),
           cp.run_plain_linear(lin, inputs, bank))
    assert cpc.run_program_cuda.launches == before + 1


def test_constraint_program_kernel_keccak_table(dev):
    """K6 on the EVM keccak table's quotient program (its eval and CTL
    checks, about 29,000 ops, more slots than shared memory holds at 32
    lanes) against the plain version."""
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.cross_table_lookup import ctl_zs_layout
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import build_stark_program
    config = StarkConfig.standard_fast_config()
    prog = build_stark_program(all_stark.KeccakStark(), config, ctl_zs_layout(
        all_stark.all_cross_table_lookups(), all_stark.KECCAK, 2))
    rng = np.random.default_rng(11)
    inputs = _rand((prog.n_inputs, 4096), 11, dev)
    inputs[:, :64] = from_u64(BOUNDARY[rng.integers(
        0, 5, size=(prog.n_inputs, 64))], dev)
    bank = from_u64(prog.scalar_bank([int(x) for x in rng.integers(
        0, P, size=prog.n_scalar_inputs, dtype=np.uint64)]), dev)
    _equal(cpc.run_program_cuda(prog, inputs, bank),
           prog.run_plain(inputs, bank))


def system_zero_program():
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import build_stark_program
    from plonky2_tpu_torch.system_zero.system_zero import SystemZero
    return build_stark_program(SystemZero(),
                               StarkConfig.standard_fast_config())


def recursion_program():
    """The quotient program of the circuit that verifies a Fibonacci
    proof (tests/test_torch_recursion.py's one-level recursion, built on
    the card under its small FRI)."""
    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.models.bench_recursion import recursion_circuit
    from plonky2_tpu_torch.models.fibonacci import build_fibonacci_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    config = CircuitConfig(fri_config=FriConfig(
        rate_bits=3, cap_height=1, proof_of_work_bits=1, num_query_rounds=2,
        reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5)))
    fib, _, _ = build_fibonacci_circuit(config)
    data, _, _ = recursion_circuit(fib.common, config)
    return build_quotient_program(data.common)


def fib_wrapper_program():
    """The Fibonacci STARK wrapper's quotient program (models/
    stark_wrapper.py: the STARK verifier in a circuit), at 2^10 rows."""
    from plonky2_tpu_torch.models.fibonacci_stark import FibonacciStark
    from plonky2_tpu_torch.models.stark_wrapper import stark_wrapper_builder
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    from plonky2_tpu_torch.stark.config import StarkConfig
    b, _ = stark_wrapper_builder(FibonacciStark(1 << 10),
                                 StarkConfig.standard_fast_config(), 10)
    return build_quotient_program(b.build_common())


def gate_set_program():
    """The U32, comparison and permutation gate set's quotient program
    (models/gate_set.py, at a few copies of each block)."""
    from plonky2_tpu_torch.models.gate_set import build_gate_set_circuit
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    common, _ = build_gate_set_circuit(build=False, memory_ops=16, chunks=16,
                                       inserts=2, u32_blocks=2)
    return build_quotient_program(common)


def ecdsa_program():
    """The ECDSA verification circuit's quotient program (models/
    ecdsa_verify.py under standard_ecc_config; nothing committed)."""
    from plonky2_tpu_torch.models.ecdsa_verify import ecdsa_builder
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    return build_quotient_program(ecdsa_builder()[0].build_common())


def arithmetic_program():
    """The range-checked arithmetic table's quotient program (its eval
    and the 96 permutation pairs of its lookups)."""
    from plonky2_tpu_torch.evm.arithmetic import ArithmeticStark
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import build_stark_program
    return build_stark_program(ArithmeticStark(range_check=True),
                               StarkConfig.standard_fast_config())


@pytest.mark.parametrize("make", [system_zero_program, recursion_program,
                                  fib_wrapper_program, gate_set_program,
                                  ecdsa_program, arithmetic_program])
def test_constraint_program_kernel_system_zero_and_recursion(dev, make):
    """K6 on System Zero's quotient program (its eval and permutation
    checks), on a recursion circuit's, on the Fibonacci wrapper's, on
    the U32 and permutation gate set's, on the ECDSA circuit's and on the
    range-checked arithmetic table's, against the plain version."""
    prog = make()
    rng = np.random.default_rng(12)
    inputs = _rand((prog.n_inputs, 4096 + 37), 12, dev)
    inputs[:, :64] = from_u64(BOUNDARY[rng.integers(
        0, 5, size=(prog.n_inputs, 64))], dev)
    bank = from_u64(prog.scalar_bank([int(x) for x in rng.integers(
        0, P, size=prog.n_scalar_inputs, dtype=np.uint64)]), dev)
    before = cpc.run_program_cuda.launches
    _equal(cpc.run_program_cuda(prog, inputs, bank),
           prog.run_plain(inputs, bank))
    assert cpc.run_program_cuda.launches == before + 1


def test_constraint_program_kernel_bank_in_device_memory(dev):
    """A bank too large for shared memory beside the slots is read from
    device memory."""
    prog = cp.random_program(np.random.default_rng(4), wave_width=8,
                             n_regs=24)
    bank = from_u64(prog.scalar_bank([5, P - 2]), dev)
    big = torch.cat([bank, _rand((29000,), 4, dev)])
    assert cpc.k6_form(cp.linearize(prog).n_slots, big.shape[0]).bank_words \
        == 0
    inputs = _rand((prog.n_inputs, 3000), 4, dev)
    _equal(cpc.run_program_cuda(prog, inputs, big),
           prog.run_plain(inputs, bank))


def test_gate_mix_session_on_card_matches_cpu(dev):
    """The gate mix (every gate of the recursion set, host witness)
    proves on the card with the bytes of its CPU proof."""
    import random

    from plonky2_tpu_torch.models.gate_mix import build_gate_mix_circuit
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    blobs = {}
    for where in (dev, "cpu"):
        data, pw, _ = build_gate_mix_circuit(device=where)
        sess = ProverSession(data, device=where)
        proof = sess.prove(pw, rng=random.Random(3))
        sess.verify(proof)
        blobs[str(where)] = serialize_proof(proof)
    assert blobs[str(dev)] == blobs["cpu"]


def test_quotient_round_on_card_matches_cpu(dev):
    """The whole round at the flagship widths and a small degree."""
    import dataclasses

    from plonky2_tpu_torch.plonk.prover import quotient_round
    prog, shape = cp.load(FLAGSHIP_NPZ)
    shape = dataclasses.replace(shape, degree_bits=6, cap_height=2)
    n = shape.degree
    wires = _rand((shape.num_wires, n), 1, "cpu")
    sigmas = _rand((shape.num_routed_wires, n), 2, "cpu")
    cs_values = _rand((shape.num_preprocessed_polys, n), 3, "cpu")
    ch = [[int(x) for x in np.random.default_rng(4 + i).integers(
        0, P, size=k, dtype=np.uint64)] for i, k in enumerate((4, 2, 2, 2))]
    outs = []
    for d in (dev, "cpu"):
        cs = PolynomialBatch.from_values(cs_values, shape.rate_bits, False,
                                         shape.cap_height, device=d)
        wb = PolynomialBatch.from_values(wires, shape.rate_bits, False,
                                         shape.cap_height, device=d)
        outs.append(quotient_round(wires, wb, sigmas, shape, prog, cs, *ch,
                                   chunk=128, device=d))
    card, cpu = outs
    _equal(card.zspp_values, cpu.zspp_values)
    _equal(card.quotient_coeffs, cpu.quotient_coeffs)
    np.testing.assert_array_equal(card.quotient_batch.merkle_tree.cap.digests,
                                  cpu.quotient_batch.merkle_tree.cap.digests)


def test_kernels_reject_bad_operands(dev):
    a = _rand((2, 16, 32), 5, dev)
    with pytest.raises(ValueError):
        nc.ntt_cols_cuda(a.transpose(1, 2))          # not contiguous
    with pytest.raises(ValueError):
        nc.ntt_cols_cuda(a, post=_rand((16, 16), 6, dev))   # wrong shape
    with pytest.raises(TypeError):
        pc.hash_leaves_cols_cuda(a[0].to(torch.int32))
    prog = cp.random_program(np.random.default_rng(0))
    with pytest.raises(ValueError):        # neither n_inputs nor n_read rows
        cpc.run_program_cuda(prog, _rand((prog.n_inputs + 1, 64), 7, dev),
                             _rand((4,), 8, dev))
    with pytest.raises(ValueError):        # bank on another device
        cpc.run_program_cuda(prog, _rand((prog.n_inputs, 64), 7, dev),
                             _rand((4,), 8, "cpu"))


def test_commit_on_card_matches_cpu(dev):
    v = np.random.default_rng(7).integers(0, P, size=(6, 1 << 9),
                                          dtype=np.uint64)
    card = PolynomialBatch.from_values(v, 3, False, 2, device=dev)
    cpu = PolynomialBatch.from_values(v, 3, False, 2, device="cpu")
    np.testing.assert_array_equal(card.leaves, cpu.leaves)
    np.testing.assert_array_equal(card.merkle_tree.cap.digests,
                                  cpu.merkle_tree.cap.digests)


def test_keccak_commit_on_card_matches_cpu(dev):
    """The Keccak configuration's commitment: the LDE on the card (its
    leaves stay there), the tree hashed on the host; equal to the CPU's,
    and no Poseidon kernel launched."""
    from plonky2_tpu_torch.hash.hashers import KECCAK_CONFIG
    v = np.random.default_rng(9).integers(0, P, size=(6, 1 << 9),
                                          dtype=np.uint64)
    before = (pc.hash_leaves_cols_cuda.launches, nc.ntt_cols_cuda.launches)
    card = PolynomialBatch.from_values(v, 3, False, 2, device=dev,
                                       hasher=KECCAK_CONFIG)
    assert card.leaves_dev.device.type == "cuda"
    assert pc.hash_leaves_cols_cuda.launches == before[0]
    assert nc.ntt_cols_cuda.launches > before[1]
    cpu = PolynomialBatch.from_values(v, 3, False, 2, device="cpu",
                                      hasher=KECCAK_CONFIG)
    np.testing.assert_array_equal(card.leaves, cpu.leaves)
    np.testing.assert_array_equal(card.merkle_tree.cap.digests,
                                  cpu.merkle_tree.cap.digests)
    assert [list(map(int, s)) for s in card.merkle_tree.prove(77).siblings] \
        == [list(map(int, s)) for s in cpu.merkle_tree.prove(77).siblings]


def test_cpu_tensor_without_device_runs_on_card(dev):
    v = torch.from_numpy(np.random.default_rng(8).integers(
        0, P, size=(6, 1 << 9), dtype=np.uint64).view(np.int64))
    before = (pc.hash_leaves_cols_cuda.launches, nc.ntt_cols_cuda.launches)
    batch = PolynomialBatch.from_values(v, 3, False, 2)
    assert batch.leaves_dev.device.type == "cuda"
    assert pc.hash_leaves_cols_cuda.launches == before[0] + 1
    assert nc.ntt_cols_cuda.launches > before[1]


@pytest.mark.parametrize("log_n", [1, 5, 9, 13, 17])
def test_fold_values_in_leaf_order_on_card(dev, log_n):
    """The FRI folds' evaluation: K5's rate-0 LDE with a shift equals the
    coset NTT (K3) followed by the bit-reversal permutation, and the CPU's
    plain versions."""
    from plonky2_tpu_torch.utils.bits import bit_reverse_indices
    coeffs = _rand((2, 1 << log_n), log_n, dev)
    shift = pow(7, 1 << 12, P)
    perm = torch.from_numpy(bit_reverse_indices(1 << log_n)).to(dev)
    got = tntt.lde_coset_ntt_bitrev(coeffs, 0, shift)
    _equal(got, tntt.coset_ntt(coeffs, shift)[:, perm])
    _equal(got, tntt.lde_coset_ntt_bitrev(coeffs.cpu(), 0, shift))


def _small_prover_data():
    """ProverData at the flagship widths and program and 2^8 rows (FRI of
    two arity-16 layers), and a random witness."""
    import dataclasses

    from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
    from plonky2_tpu_torch.plonk.prover_data import ProverData
    prog, shape = cp.load(FLAGSHIP_NPZ)
    shape = dataclasses.replace(shape, degree_bits=8, cap_height=2)
    n = shape.degree
    rng = np.random.default_rng(7)
    draw = lambda rows: rng.integers(0, P, size=(rows, n),  # noqa: E731
                                     dtype=np.uint64)
    fri = FriConfig(3, 2, 8, FriReductionStrategy.ConstantArityBits(4, 1),
                    8).fri_params(8, False)
    assert fri.reduction_arity_bits == (4, 4)
    data = ProverData(
        shape=shape,
        num_constants=shape.num_preprocessed_polys - shape.num_routed_wires,
        fri_params=fri, program=prog,
        cs_coeffs=draw(shape.num_preprocessed_polys),
        sigmas=draw(shape.num_routed_wires), circuit_digest=(1, 2, 3, 4),
        public_input_wires=((0, 0), (5, 9)))
    return data, draw(shape.num_wires)


def test_prove_on_card_matches_cpu(dev):
    """The whole proof (phases 2-8) at the flagship widths and program and
    a small degree: the card's proof equals the CPU's, number for number."""
    from plonky2_tpu_torch.plonk.prover import prove
    data, witness = _small_prover_data()
    card = prove(data, witness, device=dev)
    cpu = prove(data, witness, device="cpu")
    a, b = card.proof.opening_proof, cpu.proof.opening_proof
    assert a.pow_witness == b.pow_witness
    np.testing.assert_array_equal(a.final_poly, b.final_poly)
    for x, y in zip(a.commit_phase_merkle_caps, b.commit_phase_merkle_caps):
        np.testing.assert_array_equal(x.digests, y.digests)
    for name in ("wires", "plonk_zs_next", "quotient_polys"):
        np.testing.assert_array_equal(getattr(card.proof.openings, name),
                                      getattr(cpu.proof.openings, name))
    for ra, rb in zip(a.query_round_proofs, b.query_round_proofs):
        for (va, pa), (vb, pb) in zip(ra.initial_trees_proof.evals_proofs,
                                      rb.initial_trees_proof.evals_proofs):
            np.testing.assert_array_equal(va, vb)
            np.testing.assert_array_equal(pa.siblings, pb.siblings)
        for sa, sb in zip(ra.steps, rb.steps):
            np.testing.assert_array_equal(sa.evals, sb.evals)
            np.testing.assert_array_equal(sa.merkle_proof.siblings,
                                          sb.merkle_proof.siblings)


def test_build_on_card_matches_cpu(dev):
    """CircuitBuilder.build commits the constants-sigmas on the card: the
    hash tree of 2^5 leaves under wide_ecc_config has the CPU build's cap,
    circuit digest, coefficients and sigmas."""
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    card, _, root = build_hash_tree_circuit(CircuitConfig.wide_ecc_config(),
                                            5, device=dev)
    cpu, _, cpu_root = build_hash_tree_circuit(
        CircuitConfig.wide_ecc_config(), 5, device="cpu")
    assert root == cpu_root
    cs = card.prover_only.constants_sigmas_commitment
    assert cs.leaves_dev.device.type == "cuda"
    np.testing.assert_array_equal(card.verifier_only.constants_sigmas_cap
                                  .digests,
                                  cpu.verifier_only.constants_sigmas_cap
                                  .digests)
    np.testing.assert_array_equal(card.prover_only.circuit_digest,
                                  cpu.prover_only.circuit_digest)
    np.testing.assert_array_equal(
        cs.polynomials,
        cpu.prover_only.constants_sigmas_commitment.polynomials)
    np.testing.assert_array_equal(card.prover_only.sigmas,
                                  cpu.prover_only.sigmas)


def test_session_on_card_matches_cpu(dev):
    """ProverSession on the card and on the CPU, from the same random
    stream, give the same proof bytes, and the port's verifier accepts
    it; on the card the witness plan's Poseidon waves launch K7 once and
    the proof of work K8 once."""
    import random

    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.runtime.session import ProverSession
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    blobs = {}
    for where in (dev, "cpu"):
        data, pw, root = build_hash_tree_circuit(
            CircuitConfig.wide_ecc_config(), 5, device=where)
        sess = ProverSession(data, device=where)
        before = (pc.poseidon_wires_waves_cuda.launches,
                  pc.pow_grind_sponge_cuda.launches)
        proof = sess.prove(pw, rng=random.Random(11))
        after = (pc.poseidon_wires_waves_cuda.launches,
                 pc.pow_grind_sponge_cuda.launches)
        assert after == ((before[0] + 1, before[1] + 1) if where == dev
                         else before)
        assert proof.public_inputs == root
        sess.verify(proof)
        blobs[str(where)] = serialize_proof(proof)
    assert blobs[str(dev)] == blobs["cpu"]


def test_session_reuses_the_build_commitment_on_the_default_device(dev):
    """build() and ProverSession with no device both run on the current
    card, and the session takes build()'s constants-sigmas commitment."""
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    from plonky2_tpu_torch.runtime.session import ProverSession
    data, _, _ = build_hash_tree_circuit(CircuitConfig.wide_ecc_config(), 2)
    cs = data.prover_only.constants_sigmas_commitment
    assert cs.leaves_dev.device == dev
    assert ProverSession(data).context.cs_batch is cs


@pytest.mark.parametrize("sizes", [(1,), (33,), ((1 << 12) + 5,),
                                   (1 << 14, 1 << 10, 1 << 6, 2, 1),
                                   (5, 3, 1, 1, 1, 1, 1)])
def test_poseidon_wires_kernel(dev, sizes):
    """K7 writes the waves its plain version writes, word for word, in one
    launch: one wave, and chains of waves that read the wave before (the
    cross-block reads go through L2; chip_smoke.py:wave_chain, boundary
    values in odd rows, swaps mixed); a swap wire of 2 in the last wave
    sets the flag as the plain version does."""
    from chip_smoke import wave_chain
    from plonky2_tpu_torch.hash import poseidon_wires as pw
    values, dep, out, offsets = wave_chain(np.random.default_rng(sum(sizes)),
                                           sizes, dev)
    for bad in (False, True):
        if bad:
            values[dep[12, offsets[-2]]] = 2
        got, want = values.clone(), values.clone()
        e_got, e_want = (torch.zeros(1, dtype=torch.int32, device=dev)
                         for _ in range(2))
        before = pc.poseidon_wires_waves_cuda.launches
        pc.poseidon_wires_waves_cuda(got, dep, out, offsets, e_got)
        assert pc.poseidon_wires_waves_cuda.launches == before + 1
        pw.poseidon_wires_waves(want, dep, out, offsets, e_want)
        _equal(got, want)
        assert bool(e_got.item()) == bool(e_want.item()) == bad


@pytest.mark.parametrize("bits", [0, 1, 2, 4, 8, 12, 16])
def test_pow_grind_kernel(dev, bits):
    """K8 finds its plain version's witness at every position, from 0 and
    from an offset; at 1-4 bits many candidates of a chunk pass."""
    rng = np.random.default_rng(bits)
    for word in range(8):
        base = from_u64(rng.integers(0, P, size=12, dtype=np.uint64), dev)
        for start in (0, 1000 + word):
            before = pc.pow_grind_cuda.launches
            got = pc.pow_grind_cuda(base, word, bits, start)
            assert pc.pow_grind_cuda.launches == before + 1
            assert got == pc.pow_grind(base, word, bits, start,
                                       batch=1 << 16)


@pytest.mark.parametrize("seed", range(4))
def test_sponge_kernel(dev, seed):
    """K9 against its plain version on random transcripts from random
    buffers: every pending count, words that end on and off the rate
    boundary, caps, extension coefficients in a wider row, draws that
    refill the outputs, query indices and beta's powers; the buffer after
    each launch equal too."""
    rng = np.random.default_rng(seed)
    sources = [None, _rand((1, 1), seed, dev), _rand((1, 8 - seed), seed, dev),
               _rand((4, 16), seed, dev), _rand((2, 37), seed, dev)[:, :4],
               _rand((1, 67), seed, dev)]
    for n_in in range(9):
        for src in sources:
            n_out = 0 if src is not None else int(rng.integers(0, 9))
            buf = _rand((pc.SPONGE_WORDS,), 100 * seed + n_in, dev)
            plain_buf = buf.clone()
            n_draws = int(rng.integers(0, 30))
            arity = 1 << int(rng.integers(0, 9)) if n_draws >= 2 else 0
            mask = (1 << int(rng.integers(1, 22))) - 1
            before = pc.sponge_cuda.launches
            got = pc.sponge_cuda(buf, n_in, n_out, src, n_draws, mask, arity)
            assert pc.sponge_cuda.launches == before + 1
            want = pc.sponge(plain_buf, n_in, n_out, src, n_draws, mask,
                             arity)
            for a, b in zip(got, want):
                if b is not None:
                    _equal(a, b)
            _equal(buf, plain_buf)


@pytest.mark.parametrize("bits", [0, 1, 2, 4, 8, 12, 16, 20])
def test_pow_grind_kernel_on_the_sponge(dev, bits):
    """K8 from the sponge's buffer finds its plain version's witness for
    the duplex input state at every pending count, writes it into the
    pending slot and leaves the rest of the buffer as it was."""
    rng = np.random.default_rng(100 + bits)
    for n_in in (0, 3, 7) if bits > 12 else range(8):
        buf = from_u64(rng.integers(0, P, size=pc.SPONGE_WORDS,
                                    dtype=np.uint64), dev)
        want = pc.pow_grind(pc.duplex_input(buf, n_in), n_in, bits,
                            batch=1 << 16)
        plain_buf = buf.clone()
        plain_buf[12 + n_in] = want
        before = pc.pow_grind_sponge_cuda.launches
        out = pc.pow_grind_sponge_cuda(buf, n_in, bits)
        assert pc.pow_grind_sponge_cuda.launches == before + 1
        assert int(out[0]) == want
        _equal(buf, plain_buf)


def test_fused_fri_on_card_matches_layered(dev, monkeypatch):
    """The proof with the fused FRI (the transcript on the card: one K9
    launch a layer, one for the final polynomial, K8 on the sponge, one
    K9 launch for its witness, response and indices) equals the proof
    with the layered FRI (the host's transcript), byte for byte."""
    from plonky2_tpu_torch.fri import device_prover as tdp
    from plonky2_tpu_torch.plonk.prover import prove
    from plonky2_tpu_torch.utils.serialization import serialize_proof
    data, witness = _small_prover_data()
    blobs = {}
    for path in ("fused", "layered"):
        before = (pc.sponge_cuda.launches, pc.pow_grind_sponge_cuda.launches,
                  pc.pow_grind_cuda.launches)
        with monkeypatch.context() as m:
            if path == "layered":
                m.setattr(tdp, "device_fri_proof",
                          tdp._device_fri_proof_layered)
            blobs[path] = serialize_proof(prove(data, witness, device=dev))
        after = (pc.sponge_cuda.launches, pc.pow_grind_sponge_cuda.launches,
                 pc.pow_grind_cuda.launches)
        layers = len(data.fri_params.reduction_arity_bits)
        assert [a - b for a, b in zip(after, before)] == (
            [layers + 2, 1, 0] if path == "fused" else [0, 0, 1])
    assert blobs["fused"] == blobs["layered"]


def test_device_witness_plan_on_card_matches_host(dev):
    """The witness plan of the hash tree of 2^5 leaves on the card: one K7
    launch for its six Poseidon waves (5 levels and the public inputs'
    hash), and the host engine's wires and public inputs from the same
    random stream."""
    import random

    from plonky2_tpu_torch.iop.device_witness import build_plan
    from plonky2_tpu_torch.iop.generator import generate_partial_witness
    from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu_torch.plonk.config import CircuitConfig
    data, pw, root = build_hash_tree_circuit(CircuitConfig.wide_ecc_config(),
                                             5, device=dev)
    plan = build_plan(data.prover_only, data.common, pw, dev)
    before = pc.poseidon_wires_waves_cuda.launches
    wires, pis = plan.run(pw, random.Random(5))
    assert pc.poseidon_wires_waves_cuda.launches == before + 1
    assert wires.device.type == "cuda"
    host = generate_partial_witness(pw, data.prover_only, data.common,
                                    rng=random.Random(5))
    np.testing.assert_array_equal(to_u64(wires), host.full_witness())
    assert pis == host.get_targets(data.prover_only.public_inputs) == root
