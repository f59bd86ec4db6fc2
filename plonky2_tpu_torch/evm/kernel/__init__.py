"""The port's copy of plonky2_tpu/evm/kernel/__init__.py.

Kernel assembly toolchain: parser, assembler, optimizer, interpreter
(reference evm/src/cpu/kernel/)."""
from .assembler import BYTES_PER_OFFSET, Kernel, assemble
from .constants import evm_constants
from .interpreter import InterpreterState, KernelPanic, run_with_kernel
from .parser import parse

__all__ = ["BYTES_PER_OFFSET", "Kernel", "assemble", "evm_constants",
           "InterpreterState", "KernelPanic", "run_with_kernel", "parse"]
