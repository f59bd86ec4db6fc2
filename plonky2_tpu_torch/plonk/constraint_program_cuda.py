"""Wrapper for kernel K6, the constraint-program interpreter.

K6 replaces plonky2_tpu/plonk/constraint_program.py:
ConstraintProgram.pallas_chunk_runner; its CUDA source is
csrc/constraint_program.cu, whose header note gives the bound on an H100
and the design.  It runs the program's linear form
(``constraint_program.linearize``).  ``run_program_cuda`` takes its plain
version for a CPU tensor only; a CUDA tensor launches the kernel or the
call raises.  ``run_program_cuda.launches`` counts kernel launches.

``k6_form`` picks the kernel's form for a program: its lanes a block and
how many of its slots live in shared memory; a program whose slots do not
all fit at 32 lanes a block keeps the rest in a device scratch buffer,
which the wrapper allocates (``scratch_lanes`` lanes of each spilled slot).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from .constraint_program import ConstraintProgram, linearize

MAX_SHARED = 232448     # dynamic shared memory a block may use (sm_90)
SM_SHARED = 233472      # shared memory an SM holds (sm_90)
BLOCK_RESERVED = 1024   # shared memory the runtime keeps for each block


@dataclass(frozen=True)
class K6Form:
    lanes: int          # lanes (threads) a block: 128, 64 or 32
    n_shared: int       # slots [0, n_shared) in shared memory
    n_slots: int
    bank_words: int     # bank words in shared memory (0: device memory)

    @property
    def n_spilled(self) -> int:
        return self.n_slots - self.n_shared

    @property
    def shared_bytes(self) -> int:
        return 8 * (self.n_shared * self.lanes + self.bank_words)

    def blocks_per_sm(self) -> int:
        return max(1, SM_SHARED // (self.shared_bytes + BLOCK_RESERVED))


def k6_form(n_slots: int, bank_size: int) -> K6Form:
    """128, 64 or 32 lanes a block, the most whose slots and bank all fit
    shared memory; else 32 lanes, the bank in shared memory if it takes at
    most half of it, and as many slots as fit beside it (the busiest:
    linearize numbers them first), the rest in device scratch.  The
    kernel (csrc/constraint_program.cu) takes the form as it is given."""
    room = MAX_SHARED // 8
    for lanes in (128, 64, 32):
        if n_slots * lanes + bank_size <= room:
            return K6Form(lanes, n_slots, n_slots, bank_size)
    bank_words = bank_size if bank_size <= room // 2 else 0
    return K6Form(32, min(n_slots, (room - bank_words) // 32), n_slots,
                  bank_words)


@functools.lru_cache(maxsize=32)
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
    form = k6_form(lin.n_slots, bank.shape[0])
    scratch, scratch_lanes = None, 0
    if form.n_spilled:
        # one block's lanes for each block resident on the card at once
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = -(-C // form.lanes)
        scratch_lanes = form.lanes * min(tiles, sms * form.blocks_per_sm())
        scratch = torch.empty(form.n_spilled * scratch_lanes,
                              dtype=torch.int64, device=dev)
    kernels.call("plk_constraint_program", rows.data_ptr(), out.data_ptr(),
                 ops.data_ptr(), lin.n_ops, bank.data_ptr(), bank.shape[0],
                 input_slot.data_ptr(), out_operands.data_ptr(),
                 prog.n_outputs, lin.n_slots, form.n_shared, form.lanes,
                 int(form.bank_words > 0), kernels.ptr(scratch),
                 scratch_lanes, C, dev.index,
                 kernels.stream_of(rows))
    run_program_cuda.launches += 1
    return out


run_program_cuda.launches = 0
