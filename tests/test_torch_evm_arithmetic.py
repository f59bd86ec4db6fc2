"""The port's arithmetic table (plonky2_tpu_torch/evm/arithmetic.py)
against the JAX package's, on the CPU.

- The layout: every column constant and CTL column equals JAX's.
- Trace generation: ``generate_trace`` equals JAX's on
  tests/test_evm_arithmetic.py:mixed_ops (and each op's output is its
  Python-int ``Operation.result``), on evm/workload.py:arithmetic_ops and,
  with ``range_check``, on tests/test_evm_range_check.py:_ops (2^16 rows).
- The quotient: the compiled program's plain run (``run_plain``, K6's
  plain version) equals JAX's ``eval`` plus its permutation checks times
  1 / Z_H on random (local, next) row pairs and challenges, with and
  without ``range_check``.
- The proof of mixed_ops's table under standard_fast_config equals the
  JAX package's word for word, and the port's verifier accepts it and
  rejects a flipped opening.
- Rejections, as tests/test_evm_arithmetic.py and
  tests/test_evm_range_check.py reject them: a wrong product or residue
  and an unreduced residue (the prover's proof does not verify), and a
  limb of 2^16 in a range-checked column (trace_constraint_violations,
  the same violations as JAX's).

Exact equality (field elements).
"""
import copy
import random

import numpy as np
import pytest

import tests.test_evm_arithmetic as jtest
from plonky2_tpu.evm import arithmetic as ja
from plonky2_tpu.plonk.algebra import NumpyBatch as JaxNumpyBatch
from plonky2_tpu.stark import prover as jprover
from plonky2_tpu.stark import testing as jtesting
from plonky2_tpu.stark.config import StarkConfig as JaxStarkConfig
from plonky2_tpu.stark.permutation import \
    eval_permutation_checks as jax_permutation_checks
from plonky2_tpu.stark.stark import ConstraintConsumer as JaxConsumer
from plonky2_tpu.stark.stark import StarkEvaluationVars as JaxVars
from plonky2_tpu_torch.evm import arithmetic as ar
from plonky2_tpu_torch.evm.workload import arithmetic_ops
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.stark import testing
from plonky2_tpu_torch.stark.config import StarkConfig
from plonky2_tpu_torch.stark.prover import prove
from plonky2_tpu_torch.stark.quotient_program import (num_permutation_zs,
                                                      quotient_scalars,
                                                      stark_program)
from plonky2_tpu_torch.stark.verifier import verify_stark_proof
from plonky2_tpu_torch.system_zero.lookup import permuted_cols
from plonky2_tpu_torch.utils.serialization import proof_words
from tests.test_evm_range_check import _ops as range_check_ops
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_stark import REJECTED, one_thread
from tests.test_torch_system_zero import random_sets

P = (1 << 64) - (1 << 32) + 1
U256 = 1 << 256


def port_ops(jops):
    return [ar.Operation(o.op, o.input0, o.input1, o.modulus) for o in jops]


@pytest.fixture(scope="module")
def mixed():
    """(port ops, JAX ops) of tests/test_evm_arithmetic.py:mixed_ops as
    its module's first call draws them."""
    saved = jtest.rng
    jtest.rng = random.Random(0xA217)
    try:
        jops = jtest.mixed_ops()
    finally:
        jtest.rng = saved
    return port_ops(jops), jops


def test_layout_equals_jax():
    names = [n for n in dir(ja) if n.isupper()]
    assert [getattr(ar, n) for n in names] == [getattr(ja, n) for n in names]
    assert ar.NUM_ARITH_COLUMNS == 92 and ar.NUM_ARITH_RC_COLUMNS == 237
    for f in ("ctl_data", "ctl_data_ternary", "ctl_data_div",
              "ctl_data_mod"):
        assert [(c.linear_combination, c.constant)
                for c in getattr(ar, f)()] == \
            [(c.linear_combination, c.constant) for c in getattr(ja, f)()]
    for f in ("ctl_filter", "ctl_filter_ternary", "ctl_filter_div",
              "ctl_filter_mod"):
        c, jc = getattr(ar, f)(), getattr(ja, f)()
        assert (c.linear_combination, c.constant) == \
            (jc.linear_combination, jc.constant)
    pairs = ar.ArithmeticStark(range_check=True).permutation_pairs()
    jpairs = ja.ArithmeticStark(range_check=True).permutation_pairs()
    assert [p.column_pairs for p in pairs] == \
        [p.column_pairs for p in jpairs]
    assert len(pairs) == 2 * ar.NUM_RC_CHECKED


def test_trace_equals_jax_mixed_ops(mixed):
    ops, jops = mixed
    trace = ar.ArithmeticStark().generate_trace(ops)
    np.testing.assert_array_equal(
        trace, ja.ArithmeticStark().generate_trace(jops))
    row = 0
    for op in ops:
        assert jtest.output_of(trace, row, op) == op.result, op
        row += op.num_rows()
    # a modular op on the last row would read past it: one more row
    four = ops[5:9] * 2
    assert sum(o.num_rows() for o in four) == 16
    assert ar.ArithmeticStark().generate_trace(four).shape[1] == 32


def test_trace_equals_jax_workload():
    ops = arithmetic_ops(7, seed=5)
    np.testing.assert_array_equal(
        ar.ArithmeticStark().generate_trace(ops),
        ja.ArithmeticStark().generate_trace(
            arithmetic_ops(7, seed=5, operation=ja.Operation)))
    assert len(arithmetic_ops(2)) == 28
    assert sum(o.num_rows() for o in arithmetic_ops(2)) == 44


@pytest.fixture(scope="module")
def rc_trace():
    """tests/test_evm_range_check.py's range-checked trace (2^16 rows)."""
    stark = ar.ArithmeticStark(range_check=True)
    trace = stark.generate_trace(port_ops(range_check_ops()),
                                 min_rows=ar.RC_MIN_ROWS)
    return stark, trace


def test_range_checked_trace_equals_jax(rc_trace):
    stark, trace = rc_trace
    assert trace.shape == (237, ar.RC_MIN_ROWS)
    np.testing.assert_array_equal(
        trace, ja.ArithmeticStark(range_check=True).generate_trace(
            range_check_ops(), min_rows=ja.RC_MIN_ROWS))
    with pytest.raises(ValueError, match="2\\^16 rows"):
        stark._generate_range_check(np.zeros((237, 1 << 10), np.uint64))


def test_out_of_range_limb_rejected(rc_trace):
    """tests/test_evm_range_check.py:54-73: a limb of 2^16 with its
    masked and permuted columns recomputed violates the lookup; the
    violations are JAX's."""
    stark, trace = rc_trace
    assert testing.trace_constraint_violations(stark, trace) == []
    bad = trace.copy()
    col = ar.GENERAL_INPUT_0.start
    bad[col, 0] = ar.MASK + 1              # an add row
    filt = bad[ar.CTL_OPS].sum(axis=0)
    bad[ar.rc_masked_col(0)] = np.where(filt != 0, bad[col], 0)
    pi, pt = permuted_cols(bad[ar.rc_masked_col(0)], bad[ar.RANGE_COUNTER])
    bad[ar.rc_perm_input_col(0)] = pi
    bad[ar.rc_perm_table_col(0)] = pt
    got = testing.trace_constraint_violations(stark, bad)
    assert got and got == jtesting.trace_constraint_violations(
        ja.ArithmeticStark(range_check=True), bad)


@pytest.mark.parametrize("range_check", [False, True],
                         ids=["plain", "range check"])
def test_program_equals_jax_eval(range_check):
    """The compiled program, run plain on 64 random (local, next) row
    pairs, Z values, domain values and challenges, equals JAX's eval and
    permutation checks times 1 / Z_H."""
    stark, config = (ar.ArithmeticStark(range_check),
                     StarkConfig.standard_fast_config())
    jstark = ja.ArithmeticStark(range_check)
    prog = stark_program(stark, config)
    nch, nz, lanes = config.num_challenges, num_permutation_zs(
        stark, config), 64
    rng = np.random.default_rng(31 + range_check)

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    local, nxt = rand(stark.COLUMNS, lanes), rand(stark.COLUMNS, lanes)
    zs, zs_next = rand(nz, lanes), rand(nz, lanes)
    l_first, l_last, z_last, zh_inv = rand(4, lanes)
    alphas = [int(a) for a in rand(nch)]
    sets, jsets = random_sets(rng, max(1, stark.permutation_batch_size()),
                              nch) if range_check else ([], [])
    inputs = from_u64(np.concatenate(
        [local, nxt, zs, zs_next,
         np.stack([l_first, l_last, z_last, zh_inv])]))
    bank = from_u64(prog.scalar_bank(quotient_scalars(alphas, sets or None,
                                                      public_inputs=[])))
    got = to_u64(prog.run_plain(inputs, bank))

    alg = JaxNumpyBatch()
    consumer = JaxConsumer(alg, [np.uint64(a) for a in alphas], z_last,
                           l_first, l_last)
    vars = JaxVars(list(local), list(nxt), [])
    jstark.eval(alg, vars, consumer)
    if range_check:
        jax_permutation_checks(alg, jstark,
                               JaxStarkConfig.standard_fast_config(), vars,
                               list(zs), list(zs_next), jsets, consumer)
    want = np.stack([alg.mul(acc, zh_inv)
                     for acc in consumer.accumulators()])
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def proofs(mixed):
    """(stark, config, port proof, JAX proof) of mixed_ops's table."""
    ops, jops = mixed
    stark, config = ar.ArithmeticStark(), StarkConfig.standard_fast_config()
    trace = stark.generate_trace(ops)
    with one_thread():
        proof = prove(stark, config, trace, [], device="cpu")
    jproof = jprover.prove(ja.ArithmeticStark(),
                           JaxStarkConfig.standard_fast_config(),
                           ja.ArithmeticStark().generate_trace(jops), [],
                           use_device=False)
    return stark, config, proof, jproof


def test_proof_equals_jax(proofs):
    _, _, proof, jproof = proofs
    assert list(proof_words(proof)) == list(proof_words(jproof))


def test_verifier_accepts_and_rejects_flipped(proofs):
    stark, config, proof, _ = proofs
    verify_stark_proof(stark, proof, config)
    bad = copy.deepcopy(proof)
    bad.proof.openings.local_values[0][0] ^= np.uint64(1)
    with pytest.raises(REJECTED):
        verify_stark_proof(stark, bad, config)


def _refused(stark, trace):
    config = StarkConfig.standard_fast_config()
    with pytest.raises(REJECTED):
        verify_stark_proof(stark, prove(stark, config, trace, [],
                                        device="cpu"), config)


@pytest.mark.parametrize("opname,cols", [("mul", ar.GENERAL_INPUT_2),
                                         ("mulmod", ar.MODULAR_OUTPUT)])
def test_tampered_output_rejected(opname, cols):
    """tests/test_evm_arithmetic.py:79-93: a wrong product or residue."""
    rng = random.Random(0xA218)
    stark = ar.ArithmeticStark()
    trace = stark.generate_trace([ar.Operation(
        opname, rng.randrange(U256), rng.randrange(U256),
        rng.randrange(1, U256))])
    trace[cols.start, 0] ^= np.uint64(1)
    assert testing.trace_constraint_violations(stark, trace)
    _refused(stark, trace)


def test_unreduced_modular_output_rejected():
    """tests/test_evm_arithmetic.py:96-112: output + m, still congruent."""
    rng = random.Random(0xA219)
    m = rng.randrange(1, 1 << 128)
    a, b = rng.randrange(U256), rng.randrange(U256)
    stark = ar.ArithmeticStark()
    trace = stark.generate_trace([ar.Operation("addmod", a, b, m)])
    for c, v in zip(ar.MODULAR_OUTPUT, ar.to_limbs((a + b) % m + m)):
        trace[c, 0] = v
    assert testing.trace_constraint_violations(stark, trace)
    _refused(stark, trace)
