"""The port's CPU table (plonky2_tpu_torch/evm/cpu.py), its execution
witness (evm/generation.py) and the six-table proof against the JAX
package's, on the CPU.

- The layout: every column constant, the opcode blocks, the channels and
  every CTL column and filter equal JAX's.
- ``generate_bootstrap_kernel`` equals JAX's (trace, memory writes, sponge
  op) on tests/test_evm_cpu.py's kernel and on the block kernel.
- Every stage test of tests/test_evm_cpu.py (decode, simple logic and pc,
  jumps, context ops, fp254, shift, dup/swap, memio, syscalls), the
  low-degree test, and the execution tests of tests/test_evm_generation.py,
  tests/test_evm_syscall.py and tests/test_evm_shift_ops.py run against
  the port (tests/torch_evm_twins.py).
- The compiled CPU program under ``run_plain`` (K6's plain version)
  equals JAX's ``eval`` times 1 / Z_H on random rows, without and with
  the CTL checks of its twelve lookups.
- ``generate_kernel_execution`` on the op-coverage, syscall and shift
  kernels equals JAX's: the trace, and the memory, logic, arithmetic and
  sponge ops, and the final state.
- The six-table proof of the op-coverage kernel (tests/test_stark.py:
  make_config) equals JAX's word for word; the port's verifier accepts it
  and refuses the proof of traces with one code byte changed.
Exact equality throughout."""
import dataclasses

import numpy as np
import pytest

from plonky2_tpu.evm import all_stark as jast
from plonky2_tpu.evm import cpu as jcpu
from plonky2_tpu.evm import generation as jgen
from plonky2_tpu.evm import prover as jprover
from plonky2_tpu.evm.cross_table_lookup import CtlCheckVars as JaxCtlVars
from plonky2_tpu.evm.cross_table_lookup import \
    GrandProductChallenge as JaxChallenge
from plonky2_tpu.evm.cross_table_lookup import \
    eval_cross_table_lookup_checks as jax_ctl_checks
from plonky2_tpu.evm.kernel import assemble as jassemble
from plonky2_tpu.evm.kernel import parse as jparse
from plonky2_tpu.plonk.algebra import NumpyBatch as JaxNumpyBatch
from plonky2_tpu.stark.stark import ConstraintConsumer as JaxConsumer
from plonky2_tpu.stark.stark import StarkEvaluationVars as JaxVars
from plonky2_tpu_torch.evm import all_stark
from plonky2_tpu_torch.evm import cpu
from plonky2_tpu_torch.evm import memory as memory_mod
from plonky2_tpu_torch.evm.block import block_kernel
from plonky2_tpu_torch.evm.cross_table_lookup import (CrossTableLookupError,
                                                      GrandProductChallenge,
                                                      ctl_zs_layout)
from plonky2_tpu_torch.evm.generation import generate_kernel_execution
from plonky2_tpu_torch.evm.kernel import assemble, parse
from plonky2_tpu_torch.evm.prover import prove_all
from plonky2_tpu_torch.evm.verifier import (EvmVerificationError,
                                             verify_all_proof)
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri.verifier import FriVerificationError
from plonky2_tpu_torch.stark.quotient_program import (quotient_scalars,
                                                      stark_program)
from plonky2_tpu_torch.stark.verifier import StarkVerificationError
from plonky2_tpu_torch.utils.serialization import proof_words
from tests.test_stark import make_config as jax_make_config
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_stark import P, make_config, one_thread
from tests.torch_evm_twins import ported

CPU_TESTS = ported("test_evm_cpu")
GEN_TESTS = ported("test_evm_generation")
SYSCALL_TESTS = ported("test_evm_syscall")
SHIFT_TESTS = ported("test_evm_shift_ops")
REFUSED = (CrossTableLookupError, EvmVerificationError, FriVerificationError,
           StarkVerificationError)


def _col(c):
    return (c.linear_combination, c.constant)


def _cols(cs):
    return [_col(c) for c in cs]


def test_layout_equals_jax():
    names = [n for n in dir(jcpu) if n.isupper() and not n.startswith("_")]
    for n in names:
        got, want = getattr(cpu, n), getattr(jcpu, n)
        if n == "MEM_CHANNELS":
            got = [dataclasses.astuple(c) for c in got]
            want = [dataclasses.astuple(c) for c in want]
        assert got == want, n
    assert cpu.NUM_CPU_COLUMNS == 130 and cpu.NUM_GP_CHANNELS == 5
    assert cpu.invalid_opcodes_user() == jcpu.invalid_opcodes_user()
    assert cpu.CpuStark._STACK_BEHAVIORS == jcpu.CpuStark._STACK_BEHAVIORS
    for op in range(256):
        for mode in (False, True):
            assert cpu.decode_flags(op, mode) == jcpu.decode_flags(op, mode)


def test_ctl_columns_equal_jax():
    for f in ("keccak_sponge", "logic", "arithmetic", "arithmetic_ternary",
              "arithmetic_div", "arithmetic_mod", "code_memory"):
        assert _cols(getattr(cpu, f"ctl_data_{f}")()) == \
            _cols(getattr(jcpu, f"ctl_data_{f}")()), f
        assert _col(getattr(cpu, f"ctl_filter_{f}")()) == \
            _col(getattr(jcpu, f"ctl_filter_{f}")()), f
    for ch in range(cpu.NUM_GP_CHANNELS):
        assert _cols(cpu.ctl_data_gp_memory(ch)) == \
            _cols(jcpu.ctl_data_gp_memory(ch))
        assert _col(cpu.ctl_filter_gp_memory(ch)) == \
            _col(jcpu.ctl_filter_gp_memory(ch))


def _ctls(ctls):
    return [([(t.table, _cols(t.columns), _col(t.filter_column))
              for t in c.looking_tables],
             (c.looked_table.table, _cols(c.looked_table.columns),
              _col(c.looked_table.filter_column))) for c in ctls]


def test_cross_table_lookups_equal_jax():
    assert _ctls(all_stark.all_cross_table_lookups_with_cpu()) == \
        _ctls(jast.all_cross_table_lookups_with_cpu())
    assert _ctls(all_stark.all_cross_table_lookups()) == \
        _ctls(jast.all_cross_table_lookups())
    assert all_stark.CPU_TABLES == jast.CPU_TABLES


def mem_ops(ops):
    return [(o.filter, o.timestamp, o.is_read, o.context, o.segment, o.virt,
             o.value) for o in ops]


def sponge_ops(ops):
    return [(o.context, o.segment, o.virt, o.timestamp, bytes(o.input))
            for o in ops]


def _both_kernels(src, constants=None):
    return (assemble([parse(src)], constants or {}, optimize=False),
            jassemble([jparse(src)], dict(constants or {}), optimize=False))


@pytest.mark.parametrize("which", ["add kernel", "block kernel"])
def test_bootstrap_equals_jax(which):
    if which == "block kernel":
        k = block_kernel(in_kernel_ecrecover=False)
        from plonky2_tpu.evm.block import block_kernel as jblock_kernel
        jk = jblock_kernel(in_kernel_ecrecover=False)
    else:
        k, jk = _both_kernels(CPU_TESTS.KERNEL_SRC)
    trace, ops, sponge = cpu.generate_bootstrap_kernel(k)
    jtrace, jops, jsponge = jcpu.generate_bootstrap_kernel(jk)
    np.testing.assert_array_equal(trace, jtrace)
    assert mem_ops(ops) == mem_ops(jops)
    assert sponge_ops(sponge) == sponge_ops(jsponge)


STAGE_CASES = ["test_bootstrap_trace_writes_code_and_hash",
               "test_cpu_stark_low_degree",
               "test_decode_constraints_accept_correct_flags",
               "test_decode_constraints_reject_wrong_flag",
               "test_invalid_opcodes_bitfield",
               "test_simple_logic_and_pc_constraints",
               "test_jump_constraints",
               "test_contextops_modfp254_shift_constraints",
               "test_dup_swap_constraints", "test_memio_constraints",
               "test_syscall_constraints"]


@pytest.mark.parametrize("case", STAGE_CASES)
def test_cpu_stage_case(case):
    getattr(CPU_TESTS, case)()


def test_stage_cases_cover_the_module():
    fast = {n for n in dir(CPU_TESTS) if n.startswith("test_")
            and not any(m.name == "slow" for m in
                        getattr(getattr(CPU_TESTS, n), "pytestmark", []))}
    assert fast == set(STAGE_CASES)


EXECUTION_CASES = [
    (GEN_TESTS, "test_execution_trace_satisfies_cpu_constraints"),
    (GEN_TESTS, "test_execution_semantics"),
    (GEN_TESTS, "test_execution_memory_trace_satisfies_constraints"),
    (GEN_TESTS, "test_keccak_general_execution"),
    (SYSCALL_TESTS, "test_syscall_execution_semantics"),
    (SYSCALL_TESTS, "test_syscall_trace_satisfies_cpu_constraints"),
    (SYSCALL_TESTS, "test_syscall_row_shape"),
]


@pytest.mark.parametrize("module,case", EXECUTION_CASES,
                         ids=[c for _, c in EXECUTION_CASES])
def test_execution_case(module, case):
    getattr(module, case)()


@pytest.fixture(scope="module")
def shift_executed():
    return SHIFT_TESTS.executed._get_wrapped_function()()


@pytest.mark.parametrize("case", [
    "test_shift_semantics", "test_shift_trace_satisfies_cpu_constraints",
    "test_shift_memory_trace_satisfies_constraints"])
def test_shift_case(shift_executed, case):
    getattr(SHIFT_TESTS, case)(shift_executed)


KERNELS = {
    "op coverage": lambda: (GEN_TESTS.KERNEL_SRC, {}),
    "keccak general": lambda: (GEN_TESTS.KECCAK_KERNEL_SRC, {}),
    "syscall": lambda: (SYSCALL_TESTS.KERNEL_SRC, {}),
    "shift": lambda: (
        "GLOBAL main:\n" + SHIFT_TESTS.SHIFT_TABLE_INIT.replace(
            "GLOBAL init_shift_table:", "") + SHIFT_TESTS.MAIN_OPS,
        SHIFT_TESTS.evm_constants()),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_execution_equals_jax(name):
    k, jk = _both_kernels(*KERNELS[name]())
    ex = generate_kernel_execution(k)
    jex = jgen.generate_kernel_execution(jk)
    np.testing.assert_array_equal(ex.cpu_trace, jex.cpu_trace)
    assert mem_ops(ex.memory_ops) == mem_ops(jex.memory_ops)
    assert [(o.operator, o.input0, o.input1) for o in ex.logic_ops] == \
        [(o.operator, o.input0, o.input1) for o in jex.logic_ops]
    assert [(o.op, o.input0, o.input1, o.modulus) for o in ex.arith_ops] == \
        [(o.op, o.input0, o.input1, o.modulus) for o in jex.arith_ops]
    assert sponge_ops(ex.sponge_ops) == sponge_ops(jex.sponge_ops)
    st, jst = ex.final_state, jex.final_state
    assert (st.pc, st.stack, st.context, st.memory, st.is_kernel,
            st.gas_used) == (jst.pc, jst.stack, jst.context, jst.memory,
                             jst.is_kernel, jst.gas_used)


@pytest.mark.parametrize("with_ctl", [False, True],
                         ids=["constraints", "constraints and CTL checks"])
def test_program_equals_jax_eval(with_ctl):
    """The compiled CPU program, run plain on 64 random (local, next) row
    pairs, Z values, domain values and challenges, equals JAX's eval (and
    CTL checks) times 1 / Z_H."""
    k, jk = _both_kernels(GEN_TESTS.KERNEL_SRC)
    config = make_config()
    nch, lanes = config.num_challenges, 64
    ctls = all_stark.all_cross_table_lookups_with_cpu()
    layout = ctl_zs_layout(ctls, 0, nch) if with_ctl else []
    stark = cpu.CpuStark(k)
    prog = stark_program(stark, config, layout)
    rng = np.random.default_rng(41 + with_ctl)

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    nz = len(layout)
    local, nxt = rand(stark.COLUMNS, lanes), rand(stark.COLUMNS, lanes)
    zs, zs_next = rand(nz, lanes), rand(nz, lanes)
    l_first, l_last, z_last, zh_inv = rand(4, lanes)
    alphas = [int(a) for a in rand(nch)]
    chs = [(int(b), int(g)) for b, g in rand(nch, 2)]
    inputs = from_u64(np.concatenate(
        [local, nxt, zs, zs_next,
         np.stack([l_first, l_last, z_last, zh_inv])]))
    bank = from_u64(prog.scalar_bank(quotient_scalars(
        alphas, None, [GrandProductChallenge(b, g) for b, g in chs]
        if with_ctl else None, public_inputs=[])))
    got = to_u64(prog.run_plain(inputs, bank))

    alg = JaxNumpyBatch()
    consumer = JaxConsumer(alg, [np.uint64(a) for a in alphas], z_last,
                           l_first, l_last)
    vars = JaxVars(list(local), list(nxt), [])
    jcpu.CpuStark(jk).eval(alg, vars, consumer)
    if with_ctl:
        jlayout = [(t.columns, t.filter_column, c)
                   for ctl in jast.all_cross_table_lookups_with_cpu()
                   for c in range(nch)
                   for t in list(ctl.looking_tables) + [ctl.looked_table]
                   if t.table == 0]
        assert len(jlayout) == nz == 24
        jax_ctl_checks(alg, vars, [
            JaxCtlVars(zs[i], zs_next[i], JaxChallenge(*chs[c]), cols, filt)
            for i, (cols, filt, c) in enumerate(jlayout)], consumer)
    want = np.stack([alg.mul(acc, zh_inv)
                     for acc in consumer.accumulators()])
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def six_table():
    """(all_stark, config, traces, port proof, JAX proof) of the
    op-coverage kernel's six tables under tests/test_stark.py:
    make_config."""
    k, jk = _both_kernels(GEN_TESTS.KERNEL_SRC)
    traces = all_stark.generate_all_traces_with_cpu(k)
    jtraces = jast.generate_all_traces_with_cpu(jk)
    for t, jt in zip(traces, jtraces):
        np.testing.assert_array_equal(t, jt)
    stark, config = all_stark.make_all_stark_with_cpu(k), make_config()
    with one_thread():
        proof = prove_all(stark, config, traces, device="cpu")
    jproof = jprover.prove_all(jast.make_all_stark_with_cpu(jk),
                               jax_make_config(), jtraces,
                               use_device=False)
    return stark, config, traces, proof, jproof


def test_six_table_proof_equals_jax(six_table):
    _, _, traces, proof, jproof = six_table
    assert [t.shape[0] for t in traces] == [130, 2481, 414, 523, 21, 92]
    assert list(proof_words(proof)) == list(proof_words(jproof))


def test_six_table_proof_verifies(six_table):
    stark, config, _, proof, _ = six_table
    verify_all_proof(stark, proof, config)


def test_six_table_proof_refused_after_tampered_code_byte(six_table):
    """A code byte changed in the CPU's bootstrap write and in the
    memory table's matching write (tests/test_evm_cpu.py:60-85): the
    kernel's hash and the sponge's reads no longer agree."""
    stark, config, traces, _, _ = six_table
    bad = [t.copy() for t in traces]
    bad[0][cpu.MEM_CHANNELS[0].value[0], 0] ^= np.uint64(1)
    mem = bad[4]
    row = int(np.nonzero((mem[memory_mod.FILTER] == 1)
                         & (mem[memory_mod.IS_READ] == 0)
                         & (mem[memory_mod.ADDR_SEGMENT] == 0)
                         & (mem[memory_mod.ADDR_VIRTUAL] == 0))[0][0])
    mem[memory_mod.value_limb(0), row] ^= np.uint64(1)
    with pytest.raises(REFUSED):
        with one_thread():
            proof = prove_all(stark, config, bad, device="cpu")
        verify_all_proof(stark, proof, config)
