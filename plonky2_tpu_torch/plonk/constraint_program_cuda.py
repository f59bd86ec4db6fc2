"""Wrapper for kernel K6, the constraint-program interpreter.

K6 replaces plonky2_tpu/plonk/constraint_program.py:
ConstraintProgram.pallas_chunk_runner; its CUDA source is
csrc/constraint_program.cu, whose header note gives the bound on an H100
and the design.  It runs the program's linear form
(``constraint_program.linearize``).  ``run_program_cuda`` takes its plain
version for a CPU tensor only; a CUDA tensor launches the kernel or the
call raises.  ``run_program_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .constraint_program import ConstraintProgram, linearize


@functools.lru_cache(maxsize=8)
def device_program(prog: ConstraintProgram, device: str):
    """(ops (n_ops,) int64, input_slot (n_read,) int32, out_operands
    (n_outputs,) int32) of the program's linear form, on `device`."""
    lin = linearize(prog)
    ops = torch.from_numpy(lin.ops.view(np.int64).copy()).to(device)
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, dtype=np.int32)).to(device)
    return ops, to(lin.input_slot), to(lin.out_operands)


def run_program_cuda(prog: ConstraintProgram, inputs: torch.Tensor,
                     bank: torch.Tensor) -> torch.Tensor:
    """K6: (n_outputs, C) = the program on C lanes.

    ``inputs`` is (n_inputs, C), or (n_read, C): the rows that the linear
    form reads (``linearize(prog).input_rows``), which is all the kernel
    reads, so a caller may gather only those.  ``bank`` is the
    (bank_size,) scalar bank."""
    kernels.check_field_tensor(inputs, "inputs", 2)
    kernels.check_field_tensor(bank, "bank", 1)
    lin = linearize(prog)
    if inputs.shape[0] not in (prog.n_inputs, lin.n_read):
        raise ValueError(f"inputs: {inputs.shape[0]} rows, expected "
                         f"{prog.n_inputs} or {lin.n_read}")
    if bank.shape[0] < max(1, len(prog.bank_sids)):
        raise ValueError(f"bank: {bank.shape[0]} slots, expected "
                         f"{len(prog.bank_sids)}")
    if kernels.on_cpu(inputs):
        if inputs.shape[0] != prog.n_inputs:      # the rows read only
            full = inputs.new_zeros((prog.n_inputs, inputs.shape[1]))
            full[torch.from_numpy(lin.input_rows.astype(np.int64))] = inputs
            inputs = full
        return prog.run_plain(inputs, bank)
    dev = inputs.device
    rows = lin.compact_inputs(inputs).contiguous()
    kernels.check_kernel_operand(rows, "inputs", dev)
    kernels.check_kernel_operand(bank, "bank", dev)
    ops, input_slot, out_operands = device_program(prog, str(dev))
    C = rows.shape[1]
    out = torch.empty((prog.n_outputs, C), dtype=torch.int64, device=dev)
    kernels.call("plk_constraint_program", rows.data_ptr(), out.data_ptr(),
                 ops.data_ptr(), lin.n_ops, bank.data_ptr(), bank.shape[0],
                 input_slot.data_ptr(), out_operands.data_ptr(),
                 prog.n_outputs, lin.n_slots, C, dev.index,
                 kernels.stream_of(rows))
    run_program_cuda.launches += 1
    return out


run_program_cuda.launches = 0
