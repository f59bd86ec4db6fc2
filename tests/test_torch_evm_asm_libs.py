"""The EVM kernel's asm libraries in the port (plonky2_tpu_torch/evm/
{core,storage,accounts,bn,hashes}_asm.py) against the JAX package's, on the
CPU.

- The five assembly strings are the JAX package's text; HASHES_ASM, which
  Python helpers emit, equals the JAX string.
- Every case of tests/test_core_asm.py, tests/test_accounts_asm.py,
  tests/test_bn_asm.py, tests/test_hashes_asm.py and tests/test_mpt_ptr.py
  runs against the port, each assembly made by both packages with equal
  code bytes, code hash, labels and prover-input offsets, and each
  interpreter run by both with equal final stacks and memory, or the same
  panic on both sides (tests/torch_evm_twins.py).
"""
import pytest

from plonky2_tpu.evm import accounts_asm as jaccounts_asm
from plonky2_tpu.evm import bn_asm as jbn_asm
from plonky2_tpu.evm import core_asm as jcore_asm
from plonky2_tpu.evm import hashes_asm as jhashes_asm
from plonky2_tpu.evm import storage_asm as jstorage_asm
from plonky2_tpu_torch.evm import (accounts_asm, bn_asm, core_asm, hashes_asm,
                                   storage_asm)
from tests.torch_evm_twins import ported

MODULES = {name: ported(name) for name in (
    "test_core_asm", "test_accounts_asm", "test_bn_asm", "test_hashes_asm",
    "test_mpt_ptr")}
CASES = [(name, case) for name, module in MODULES.items()
         for case in sorted(n for n in dir(module) if n.startswith("test_"))]


def test_asm_text_equals_jax():
    assert core_asm.CORE_ASM == jcore_asm.CORE_ASM
    assert storage_asm.STORAGE_ASM == jstorage_asm.STORAGE_ASM
    assert accounts_asm.ACCOUNTS_ASM == jaccounts_asm.ACCOUNTS_ASM
    assert bn_asm.BN_ASM == jbn_asm.BN_ASM
    assert hashes_asm.HASHES_ASM == jhashes_asm.HASHES_ASM


def test_cases_listed():
    counts = {name: sum(1 for n, _ in CASES if n == name) for name in MODULES}
    assert counts == {"test_core_asm": 5, "test_accounts_asm": 5,
                      "test_bn_asm": 3, "test_hashes_asm": 3,
                      "test_mpt_ptr": 19}


@pytest.fixture(scope="module")
def kernels():
    """Each module's `kernel` fixture, made once (assembled by both
    packages through the twin) on first use."""
    return {}


@pytest.mark.parametrize("name,case", CASES,
                         ids=[f"{n[5:]}::{c}" for n, c in CASES])
def test_asm_case(kernels, name, case):
    if name not in kernels:
        kernels[name] = MODULES[name].kernel._get_wrapped_function()()
    getattr(MODULES[name], case)(kernels[name])
