"""The port's kernel assembler and interpreter
(plonky2_tpu_torch/evm/kernel/) against the JAX package's, on the CPU.

- Every case of tests/test_kernel_asm.py runs against the port, each
  assembly made by both packages with equal code bytes, code hash, labels
  and prover-input offsets, each interpreter run by both with equal final
  stacks and memory, and the panic on both sides
  (tests/torch_evm_twins.py).
- The block kernel (evm/block.py:block_kernel) under both settings of
  ``in_kernel_ecrecover`` equals the JAX package's byte for byte, with
  equal code hashes, labels and prover-input offsets.
- Every case of tests/test_secp_asm.py, tests/test_mpt_asm.py and
  tests/test_txn_asm.py against the port: each ``run_with_kernel`` made
  by both interpreters, which end with equal stacks and memory; the
  invalid signatures are refused on both.
- The assembly libraries (stdlib, asm_util, txn/mpt/secp asm) are the
  JAX package's text, and ``evm_constants`` its constants.
"""
import pytest

from plonky2_tpu.evm import block as jblock
from plonky2_tpu.evm import mpt_asm as jmpt_asm
from plonky2_tpu.evm import secp_asm as jsecp_asm
from plonky2_tpu.evm import txn_asm as jtxn_asm
from plonky2_tpu.evm.kernel import asm_util as jasm_util
from plonky2_tpu.evm.kernel import constants as jconstants
from plonky2_tpu.evm.kernel import stdlib as jstdlib
from plonky2_tpu_torch.evm import block, mpt_asm, secp_asm, txn_asm
from plonky2_tpu_torch.evm.kernel import asm_util, constants, stdlib
from tests.torch_evm_twins import kernel_fields, ported

ASM = ported("test_kernel_asm")
SECP = ported("test_secp_asm")
MPT = ported("test_mpt_asm")
TXN = ported("test_txn_asm")

KERNEL_ASM_CASES = sorted(n for n in dir(ASM) if n.startswith("test_"))


@pytest.mark.parametrize("case", KERNEL_ASM_CASES)
def test_kernel_asm_case(case):
    getattr(ASM, case)()


def test_kernel_asm_cases_listed():
    assert len(KERNEL_ASM_CASES) == 13


@pytest.mark.parametrize("in_kernel_ecrecover", [False, True],
                         ids=["sender as prover input", "in-kernel ecrecover"])
def test_block_kernel_equals_jax(in_kernel_ecrecover):
    k = block.block_kernel(in_kernel_ecrecover=in_kernel_ecrecover)
    jk = jblock.block_kernel(in_kernel_ecrecover=in_kernel_ecrecover)
    assert kernel_fields(k) == kernel_fields(jk)
    assert len(k.code) == (11846 if in_kernel_ecrecover else 11853)


def test_asm_text_and_constants_equal_jax():
    assert stdlib.SHIFT_TABLE_INIT == jstdlib.SHIFT_TABLE_INIT
    assert asm_util.UTIL_ASM == jasm_util.UTIL_ASM
    assert txn_asm.TXN_ASM == jtxn_asm.TXN_ASM
    assert mpt_asm.MPT_ASM == jmpt_asm.MPT_ASM
    assert secp_asm.SECP_ASM == jsecp_asm.SECP_ASM
    assert constants.evm_constants() == jconstants.evm_constants()
    assert txn_asm.txn_field_constants() == jtxn_asm.txn_field_constants()


def _fixture(module, name):
    return getattr(module, name)._get_wrapped_function()()


@pytest.fixture(scope="module")
def secp_kernel():
    return _fixture(SECP, "kernel")


@pytest.fixture(scope="module")
def mpt_kernel():
    return _fixture(MPT, "kernel")


@pytest.fixture(scope="module")
def txn_parse_kernel():
    return _fixture(TXN, "parse_kernel")


def _cases(module, fixture):
    """The module's test functions that take (only) `fixture`."""
    return sorted(n for n in dir(module) if n.startswith("test_")
                  and getattr(module, n).__code__.co_varnames[
                      :getattr(module, n).__code__.co_argcount]
                  == ((fixture,) if fixture else ()))


SECP_CASES = _cases(SECP, "kernel")
MPT_CASES = _cases(MPT, "kernel")
TXN_CASES = _cases(TXN, None)


def test_interpreter_cases_listed():
    assert (len(SECP_CASES), len(MPT_CASES), len(TXN_CASES)) == (12, 13, 2)
    assert _cases(TXN, "parse_kernel") == ["test_parse_type_0_txn"]


@pytest.mark.parametrize("case", SECP_CASES)
def test_secp_asm_case(secp_kernel, case):
    getattr(SECP, case)(secp_kernel)


@pytest.mark.parametrize("case", MPT_CASES)
def test_mpt_asm_case(mpt_kernel, case):
    getattr(MPT, case)(mpt_kernel)


def test_txn_asm_parse_type_0(txn_parse_kernel):
    TXN.test_parse_type_0_txn(txn_parse_kernel)


@pytest.mark.parametrize("case", TXN_CASES)
def test_txn_asm_case(case):
    getattr(TXN, case)()
