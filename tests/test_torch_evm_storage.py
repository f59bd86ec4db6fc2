"""The storage-op execution (SLOAD/SSTORE through the syscall jumptable to
evm/storage_asm.py's handlers) in the port against the JAX package's, on
the CPU.

The port's kernel and prover inputs (evm/workload.py:storage_ops_kernel,
storage_ops_inputs) equal tests/test_storage_ops.py's, built by the JAX
package.  Each package executes its kernel once (module fixture, since
one execution takes tens of seconds); then:

- the port's execution ends with tests/test_storage_ops.py's read-backs
  and the state root of the trie built by hand after both writes;
- the six traces (evm/all_stark.py:generate_all_traces_with_cpu) equal the
  JAX package's, at the shapes the kernel's run gives;
- the CPU table's trace, with its syscall and EXIT_KERNEL rows, violates
  none of the CPU STARK's constraints.
"""
import numpy as np
import pytest

import tests.test_storage_ops as jstorage
from plonky2_tpu.evm import generation as jgeneration
from plonky2_tpu.evm.all_stark import \
    generate_all_traces_with_cpu as jgenerate_all_traces_with_cpu
from plonky2_tpu.evm.mpt import all_mpt_prover_inputs as jall_mpt_prover_inputs
from plonky2_tpu_torch.evm import cpu, workload
from plonky2_tpu_torch.evm.all_stark import generate_all_traces_with_cpu
from plonky2_tpu_torch.stark.testing import trace_constraint_violations
from tests.torch_evm_twins import kernel_fields


def _jax_inputs():
    state, storage, _ = jstorage._fixture()
    return jall_mpt_prover_inputs(jstorage.TrieInputs(
        state_trie=state, storage_tries=[(jstorage.ADDR, storage)]))


@pytest.fixture(scope="module")
def runs():
    """(port kernel, port execution, port traces, JAX kernel, JAX
    execution, JAX traces)."""
    kernel = workload.storage_ops_kernel()
    ex = workload.storage_ops_execution(kernel)
    traces = generate_all_traces_with_cpu(kernel, execution=ex)
    jkernel = jstorage._kernel(jstorage._addr_key(jstorage.ADDR).packed)
    jdata = _jax_inputs()
    jex = jgeneration.generate_kernel_execution(
        jkernel, prover_input_factory=lambda: jstorage.Provider(jdata))
    jtraces = jgenerate_all_traces_with_cpu(jkernel, execution=jex)
    return kernel, ex, traces, jkernel, jex, jtraces


def test_storage_kernel_and_inputs_equal_jax(runs):
    kernel, _, _, jkernel, _, _ = runs
    assert kernel_fields(kernel) == kernel_fields(jkernel)
    data, _ = workload.storage_ops_inputs()
    assert [int(x) for x in data] == [int(x) for x in _jax_inputs()]


def test_storage_readback_and_state_root(runs):
    _, ex, _, _, jex, _ = runs
    got = workload.storage_ops_readback(ex)
    _, want = workload.storage_ops_inputs()
    assert got == want
    assert got[20] == jstorage.VAL_A and got[21] == 0
    assert got[22] == jstorage.NEW_A
    assert got == workload.storage_ops_readback(jex)


def test_storage_traces_equal_jax(runs):
    _, _, traces, _, _, jtraces = runs
    assert [t.shape for t in traces] == [
        (130, 1 << 17), (2481, 1 << 11), (414, 1 << 7), (523, 1 << 9),
        (21, 1 << 19), (92, 1 << 13)]
    assert [t.shape for t in traces] == [t.shape for t in jtraces]
    for t, jt in zip(traces, jtraces):
        np.testing.assert_array_equal(t, jt)


def test_storage_cpu_constraints(runs):
    kernel, _, traces, _, _, _ = runs
    assert trace_constraint_violations(cpu.CpuStark(kernel), traces[0]) == []
