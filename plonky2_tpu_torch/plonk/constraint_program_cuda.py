"""Wrapper for kernel K6, the constraint-program interpreter.

K6 replaces plonky2_tpu/plonk/constraint_program.py:
ConstraintProgram.pallas_chunk_runner; its CUDA source is
csrc/constraint_program.cu, whose header note gives the bound on an H100
and the design.  ``run_program_cuda`` takes its plain version
(``ConstraintProgram.run_plain``) for a CPU tensor only; a CUDA tensor
launches the kernel or the call raises.  ``run_program_cuda.launches``
counts kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .constraint_program import ConstraintProgram


@functools.lru_cache(maxsize=8)
def device_program(prog: ConstraintProgram, device: str):
    """(opcodes (n_waves,), slots (n_waves, W, 4) = dst/a/b/c, out_regs)
    as int32 tensors on `device`."""
    slots = np.stack([prog.wave_dst, prog.wave_a, prog.wave_b, prog.wave_c],
                     axis=-1).astype(np.int32)
    to = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x, dtype=np.int32)).to(device)
    return to(prog.wave_opcodes), to(slots), to(prog.out_regs)


def run_program_cuda(prog: ConstraintProgram, inputs: torch.Tensor,
                     bank: torch.Tensor) -> torch.Tensor:
    """K6: (n_outputs, C) = the program on C lanes.

    ``inputs`` is (n_inputs, C), or an (n_regs, C) register file whose first
    n_inputs rows hold the inputs; the kernel then runs in it in place and
    clobbers it (the quotient gathers straight into its rows, so no copy is
    made).  ``bank`` is the (bank_size,) scalar bank."""
    kernels.check_field_tensor(inputs, "inputs", 2)
    kernels.check_field_tensor(bank, "bank", 1)
    if inputs.shape[0] not in (prog.n_inputs, prog.n_regs):
        raise ValueError(f"inputs: {inputs.shape[0]} rows, expected "
                         f"{prog.n_inputs} or {prog.n_regs}")
    if bank.shape[0] < max(1, len(prog.bank_sids)):
        raise ValueError(f"bank: {bank.shape[0]} slots, expected "
                         f"{len(prog.bank_sids)}")
    if kernels.on_cpu(inputs):
        return prog.run_plain(inputs[:prog.n_inputs], bank)
    dev = inputs.device
    C = inputs.shape[1]
    if inputs.shape[0] == prog.n_regs:
        regs = inputs
        kernels.check_kernel_operand(regs, "regs", dev)
    else:
        regs = torch.empty((prog.n_regs, C), dtype=torch.int64, device=dev)
        regs[:prog.n_inputs] = inputs
    kernels.check_kernel_operand(bank, "bank", dev)
    opcodes, slots, out_regs = device_program(prog, str(dev))
    out = torch.empty((prog.n_outputs, C), dtype=torch.int64, device=dev)
    kernels.call("plk_constraint_program", regs.data_ptr(), out.data_ptr(),
                 opcodes.data_ptr(), slots.data_ptr(), bank.data_ptr(),
                 out_regs.data_ptr(), prog.n_waves, prog.wave_width,
                 prog.n_outputs, C, dev.index, kernels.stream_of(regs))
    run_program_cuda.launches += 1
    return out


run_program_cuda.launches = 0
