"""System Zero in the port against the JAX package, on the CPU.

- The unit tests of tests/test_system_zero.py (the ALU's operations, the
  permutation unit, the lookup's permuted columns), as cases on the port's
  ``ScalarBase``: the port generates the JAX package's row, and its
  constraint accumulators equal JAX's on that row (and are zero).
- The 2^16-row trace equals JAX's column for column, and the permutation
  Z columns equal JAX's.
- The compiled quotient program's plain run (``run_plain``, K6's plain
  version) equals JAX's ``eval`` plus its permutation checks on 64 random
  (local, next) row pairs with random challenges.
- The whole proof at 2^16 rows, as tests/test_system_zero.py's heavy test.
"""
import random

import numpy as np
import pytest

import plonky2_tpu.system_zero.registers as JR
from plonky2_tpu.plonk.algebra import NumpyBatch as JaxNumpyBatch
from plonky2_tpu.plonk.algebra import ScalarBase as JaxScalarBase
from plonky2_tpu.stark.config import StarkConfig as JaxStarkConfig
from plonky2_tpu.stark.permutation import \
    PermutationChallenge as JaxPermChallenge
from plonky2_tpu.stark.permutation import \
    PermutationChallengeSet as JaxPermSet
from plonky2_tpu.stark.permutation import \
    compute_permutation_z_polys as jax_z_polys
from plonky2_tpu.stark.permutation import \
    eval_permutation_checks as jax_permutation_checks
from plonky2_tpu.stark.stark import ConstraintConsumer as JaxConsumer
from plonky2_tpu.stark.stark import StarkEvaluationVars as JaxVars
from plonky2_tpu.system_zero import alu as jalu
from plonky2_tpu.system_zero import permutation_unit as jperm
from plonky2_tpu.system_zero.lookup import permuted_cols as jax_permuted
from plonky2_tpu.system_zero.system_zero import SystemZero as JaxSystemZero
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.plonk.algebra import ScalarBase
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.permutation import (PermutationChallenge,
                                                 PermutationChallengeSet,
                                                 compute_permutation_z_polys)
from plonky2_tpu_torch.stark.quotient_program import (num_permutation_zs,
                                                      quotient_scalars,
                                                      stark_program)
from plonky2_tpu_torch.stark.stark import (ConstraintConsumer,
                                           StarkEvaluationVars)
from plonky2_tpu_torch.system_zero import alu
from plonky2_tpu_torch.system_zero import registers as R
from plonky2_tpu_torch.system_zero.lookup import permuted_cols
from plonky2_tpu_torch.system_zero.permutation_unit import (
    eval_permutation_unit, generate_permutation_unit)
from plonky2_tpu_torch.system_zero.system_zero import (MIN_TRACE_ROWS,
                                                       SystemZero)
from tests.test_torch_prover import one_torch_thread  # noqa: F401

P = (1 << 64) - (1 << 32) + 1
ALPHAS = [2, 3, 5]


def test_layout_equals_jax():
    assert R.NUM_COLUMNS == JR.NUM_COLUMNS == 558
    assert R.NUM_LOOKUPS == JR.NUM_LOOKUPS == 11
    names = [n for n in dir(JR) if n.isupper()]
    assert [getattr(R, n) for n in names] == [getattr(JR, n) for n in names]


def accumulators(eval_fn, jax_eval_fn, row, vars_of=None):
    """The port's and JAX's accumulators of one evaluation on `row`."""
    out = []
    for alg, consumer_cls, fn in ((ScalarBase(), ConstraintConsumer,
                                   eval_fn),
                                  (JaxScalarBase(), JaxConsumer,
                                   jax_eval_fn)):
        consumer = consumer_cls(alg, ALPHAS, 1, 1, 1)
        fn(alg, row if vars_of is None else vars_of(row), consumer)
        out.append(consumer.accumulators())
    return out


def alu_row(rng, op, inputs, trial):
    row = [0] * R.NUM_COLUMNS
    row[op] = 1
    for col, bound in inputs:
        row[col] = rng.randrange(bound)
    if op == R.IS_DIV and trial == 0:
        row[R.COL_DIV_INPUT_DIVISOR] = 0     # division by zero
    return row


def bitop_row(rng, op, _trial):
    row = [0] * R.NUM_COLUMNS
    row[op] = 1
    for regs in (R.COL_BIT_DECOMP_INPUT_A_LO_BIN_REGS,
                 R.COL_BIT_DECOMP_INPUT_A_HI_BIN_REGS,
                 R.COL_BIT_DECOMP_INPUT_B_LO_BIN_REGS,
                 R.COL_BIT_DECOMP_INPUT_B_HI_BIN_REGS):
        for r in regs:
            row[r] = rng.randrange(2)
    return row


def rotate_row(rng, op, _trial):
    row = [0] * R.NUM_COLUMNS
    row[op] = 1
    row[R.COL_ROTATE_SHIFT_INPUT_LO] = rng.randrange(1 << 32)
    row[R.COL_ROTATE_SHIFT_INPUT_HI] = rng.randrange(1 << 32)
    for r in R.COL_ROTATE_SHIFT_EXP_BITS:
        row[r] = rng.randrange(2)
    row[R.COL_ROTATE_SHIFT_DELTA_DIV32] = rng.randrange(2)
    return row


ARITH = [
    (R.IS_ADD, [(R.COL_ADD_INPUT_0, 1 << 32), (R.COL_ADD_INPUT_1, 1 << 32),
                (R.COL_ADD_INPUT_2, 1 << 32)]),
    (R.IS_SUB, [(R.COL_SUB_INPUT_0, 1 << 32), (R.COL_SUB_INPUT_1, 1 << 32)]),
    (R.IS_MUL_ADD, [(R.COL_MUL_ADD_FACTOR_0, 1 << 32),
                    (R.COL_MUL_ADD_FACTOR_1, 1 << 32),
                    (R.COL_MUL_ADD_ADDEND, 1 << 32)]),
    (R.IS_DIV, [(R.COL_DIV_INPUT_DIVIDEND, 1 << 32),
                (R.COL_DIV_INPUT_DIVISOR, 1 << 32)]),
]
ALU_CASES = (
    [("arith", op, (lambda rng, op, t, inp=inp: alu_row(rng, op, inp, t)),
      "generate_alu") for op, inp in ARITH]
    + [("bitop", op, bitop_row, "generate_alu")
       for op in (R.IS_AND, R.IS_IOR, R.IS_XOR, R.IS_ANDNOT)]
    + [("rotate_shift", op, rotate_row, "generate_rotate_shift")
       for op in (R.IS_ROTATE_LEFT, R.IS_ROTATE_RIGHT, R.IS_SHIFT_LEFT,
                  R.IS_SHIFT_RIGHT)])


@pytest.mark.parametrize("kind,op,make_row,gen", ALU_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in ALU_CASES])
def test_alu_gen_eval_equals_jax(kind, op, make_row, gen):
    """tests/test_system_zero.py's arith, bitop and rotate/shift tests:
    the port's generated row is JAX's and satisfies the ALU's constraints,
    and the accumulators equal JAX's."""
    rng = random.Random(0x5150 + op)
    for trial in range(4 if kind != "bitop" else 1):
        row = make_row(rng, op, trial)
        jrow = list(row)
        if gen == "generate_alu":
            alu.generate_alu(row)
            jalu.generate_alu(jrow)
        else:
            alu.generate_rotate_shift(row, op)
            jalu.generate_rotate_shift(jrow, op)
        assert row == jrow
        port, jax = accumulators(alu.eval_alu, jalu.eval_alu, row)
        assert port == jax == [0] * len(ALPHAS)


def test_alu_garbage_equals_jax():
    """Random rows: with IS_DIV off the division constraints hold for any
    values (tests/test_system_zero.py), and on any random row the ALU's
    accumulators equal JAX's."""
    rng = random.Random(7)
    for _ in range(3):
        row = [rng.randrange(P) for _ in range(R.NUM_COLUMNS)]
        row[R.IS_DIV] = 0
        port, jax = accumulators(alu.eval_division, jalu.eval_division, row)
        assert port == jax == [0] * len(ALPHAS)
        port, jax = accumulators(alu.eval_alu, jalu.eval_alu, row)
        assert port == jax and any(port)


def test_rotate_semantics_vs_python():
    rng = random.Random(13)
    row = [0] * R.NUM_COLUMNS
    row[R.IS_ROTATE_LEFT] = 1
    x = rng.randrange(1 << 64)
    row[R.COL_ROTATE_SHIFT_INPUT_LO] = x & 0xFFFFFFFF
    row[R.COL_ROTATE_SHIFT_INPUT_HI] = x >> 32
    for i, r in enumerate(R.COL_ROTATE_SHIFT_EXP_BITS):
        row[r] = (13 >> i) & 1             # delta 13, delta_div32 0
    alu.generate_rotate_shift(row, R.IS_ROTATE_LEFT)
    got = ((row[R.COL_ROTATE_SHIFT_OUTPUT_1] << 32)
           | row[R.COL_ROTATE_SHIFT_OUTPUT_0])
    assert got == ((x << 13) | (x >> 51)) & ((1 << 64) - 1)


def test_permutation_unit_equals_jax():
    rng = random.Random(17)
    row = [0] * R.NUM_COLUMNS
    inputs = [rng.randrange(P) for _ in range(12)]
    for i in range(12):
        row[R.col_perm_input(i)] = inputs[i]
    jrow = list(row)
    generate_permutation_unit(row)
    jperm.generate_permutation_unit(jrow)
    assert row == jrow
    assert [row[R.col_perm_output(i)] for i in range(12)] == \
        pos.permute_ints(inputs)

    port, jax = accumulators(
        eval_permutation_unit, jperm.eval_permutation_unit, row,
        vars_of=lambda r: StarkEvaluationVars(r, r, [0, 0]))
    assert port == jax == [0] * len(ALPHAS)


def test_permuted_cols_equals_jax():
    rng = random.Random(19)
    n = 256
    table = np.array([rng.randrange(1 << 16) for _ in range(n)],
                     dtype=np.uint64)
    inputs = np.array([int(table[rng.randrange(n)]) for _ in range(n)],
                      dtype=np.uint64)
    pi, pt = permuted_cols(inputs, table)
    jpi, jpt = jax_permuted(inputs, table)
    np.testing.assert_array_equal(pi, jpi)
    np.testing.assert_array_equal(pt, jpt)
    assert pi[0] == pt[0]
    for k in range(1, n):
        assert pi[k] == pt[k] or pi[k] == pi[k - 1]


@pytest.fixture(scope="module")
def trace():
    t = SystemZero().generate_trace()
    assert t.shape == (R.NUM_COLUMNS, MIN_TRACE_ROWS)
    return t


def test_trace_equals_jax(trace):
    np.testing.assert_array_equal(trace, JaxSystemZero().generate_trace())
    with pytest.raises(ValueError):
        SystemZero().generate_trace(MIN_TRACE_ROWS // 2)


def random_sets(rng, num_sets: int, nch: int):
    vals = rng.integers(0, P, size=(num_sets, nch, 2),
                        dtype=np.uint64).tolist()
    return ([PermutationChallengeSet([PermutationChallenge(b, g)
                                      for b, g in s]) for s in vals],
            [JaxPermSet([JaxPermChallenge(b, g) for b, g in s])
             for s in vals])


def test_z_columns_equal_jax(trace):
    stark, config = SystemZero(), StarkConfig.standard_fast_config()
    sets, jsets = random_sets(np.random.default_rng(23),
                              stark.permutation_batch_size(),
                              config.num_challenges)
    zs = to_u64(compute_permutation_z_polys(stark, config, from_u64(trace),
                                            sets))
    assert zs.shape == (num_permutation_zs(stark, config), MIN_TRACE_ROWS)
    np.testing.assert_array_equal(zs, jax_z_polys(
        JaxSystemZero(), JaxStarkConfig.standard_fast_config(), trace,
        jsets))


def test_program_equals_jax_eval():
    """The compiled quotient program, run plain on 64 random (local,
    next) row pairs, Z values, domain values and challenges, equals JAX's
    eval and permutation checks times 1 / Z_H."""
    stark, config = SystemZero(), StarkConfig.standard_fast_config()
    prog = stark_program(stark, config)
    nch, nz, lanes = config.num_challenges, num_permutation_zs(
        stark, config), 64
    rng = np.random.default_rng(29)

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    local, nxt = rand(R.NUM_COLUMNS, lanes), rand(R.NUM_COLUMNS, lanes)
    zs, zs_next = rand(nz, lanes), rand(nz, lanes)
    l_first, l_last, z_last, zh_inv = rand(4, lanes)
    alphas = [int(a) for a in rand(nch)]
    pis = [int(p) for p in rand(R.NUM_PUBLIC_INPUTS)]
    sets, jsets = random_sets(rng, stark.permutation_batch_size(), nch)

    inputs = from_u64(np.concatenate(
        [local, nxt, zs, zs_next, np.stack([l_first, l_last, z_last,
                                            zh_inv])]))
    bank = from_u64(prog.scalar_bank(quotient_scalars(alphas, sets,
                                                      public_inputs=pis)))
    got = to_u64(prog.run_plain(inputs, bank))

    alg = JaxNumpyBatch()
    jstark = JaxSystemZero()
    consumer = JaxConsumer(alg, [np.uint64(a) for a in alphas], z_last,
                           l_first, l_last)
    vars = JaxVars(list(local), list(nxt), [np.uint64(p) for p in pis])
    jstark.eval(alg, vars, consumer)
    jax_permutation_checks(alg, jstark, JaxStarkConfig.standard_fast_config(),
                           vars, list(zs), list(zs_next), jsets, consumer)
    want = np.stack([alg.mul(acc, zh_inv)
                     for acc in consumer.accumulators()])
    np.testing.assert_array_equal(got, want)


@pytest.mark.heavy
def test_system_zero_prove_verify(trace):
    """tests/test_system_zero.py:test_system_zero_prove_verify on the
    port, on the CPU: prove at 2^16 rows under standard_fast_config and
    verify; a flipped opening is rejected."""
    import copy

    from plonky2_tpu_torch.fri.verifier import FriVerificationError
    from plonky2_tpu_torch.stark.prover import prove
    from plonky2_tpu_torch.stark.verifier import (StarkVerificationError,
                                                  verify_stark_proof)
    stark, config = SystemZero(), StarkConfig.standard_fast_config()
    proof = prove(stark, config, trace, [0, 0], device="cpu")
    verify_stark_proof(stark, proof, config)
    bad = copy.deepcopy(proof)
    bad.proof.openings.local_values[0][0] ^= np.uint64(1)
    with pytest.raises((StarkVerificationError, FriVerificationError)):
        verify_stark_proof(stark, bad, config)
