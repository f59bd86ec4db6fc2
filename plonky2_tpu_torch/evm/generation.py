"""The port's copy of plonky2_tpu/evm/generation.py (the same traces
and ops; a row's channels are read back in one numpy op).

Full kernel-execution witness generation for the CPU table.

This is the role of the reference's `evm/src/witness/{operation,transition}.rs`
and `generation/mod.rs`: execute assembled kernel bytecode cycle by cycle,
filling one CPU trace row per cycle such that every implemented constraint
stage is satisfied, and emitting the memory / logic operations the
cross-table lookups oblige (one memory read of the code byte per cycle plus
one memory op per used general-purpose channel, reference
cpu_stark.rs:52-112; one logic-table row per AND/OR/XOR).

Layout of the generated trace (reference generation/mod.rs:71-121): the
bootstrap rows write the kernel code to memory and expose the code-hash
sponge lookup (`cpu.generate_bootstrap_kernel`), then cycle rows run from
``main`` in kernel mode with an empty stack until the halt loop
(``halt_pc0``/``halt_pc1``) is reached, and keep spinning that loop until
the power-of-two trace is full — the control-flow stage requires the last
row to sit inside the loop (cpu.py _eval_control_flow,
reference control_flow.rs:67-107).

The memory ops for used channels are derived by scanning the wired channel
columns after each row is filled, so the CPU-side CTL values and the memory
table rows cannot drift apart.

Supported op set: the ops with in-table constraint stages (PUSH, POP, DUP,
SWAP, NOT, EQ, ISZERO, AND/OR/XOR via the logic CTL, GETPC, JUMPDEST,
JUMP/JUMPI, GET/SET_CONTEXT, MLOAD/MSTORE_GENERAL) plus the 256-bit
arithmetic ops: ADD/MUL/SUB/LT/GT results are bound to the arithmetic
table via a live CTL (which the reference never wires), and
KECCAK_GENERAL hashes a memory range through the sponge CTL (digest
pushed in the sponge's little-endian u32-limb encoding).  PROVER_INPUT
executes through a pluggable provider (evm/block.py BlockProverInputs,
reference generation/prover_input.rs).  SYSCALL traps through the kernel's
syscall jumptable and EXIT_KERNEL returns (reference operation.rs:486-523,
553-580); GAS/CONSUME_GAS execute with real gas accounting (the reference
leaves both as todo!(), transition.rs:212-216).  User-mode execution
fetches code from the context's Code segment and requires jumpdest bits
for taken jumps.  DIV/MOD execute but their two-row modular CTL is future
work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..field import goldilocks as gl
from .cpu import (CLOCK, CODE_CONTEXT, IS_KERNEL_MODE, JUMPS_COND_SUM_PINV,
                  JUMPS_SHOULD_JUMP, MEM_CHANNELS, MEM_CODE_CHANNEL_IDX,
                  MEM_GP_CHANNELS_IDX_START, NUM_CHANNELS, NUM_CPU_COLUMNS,
                  NUM_GP_CHANNELS, OP, PROGRAM_COUNTER, STACK_LEN, VALUE_LIMBS,
                  channel_cols, fill_cycle_row, generate_bootstrap_kernel,
                  set_eq_iszero_values, set_stack_bounds_aux, set_u256_channel,
                  u256_limbs, wire_stack_op)
from .arithmetic import Operation as ArithOp
from .kernel.assembler import Kernel
from .keccak_sponge import KeccakSpongeOp
from .logic import Operation as LogicOp
from .memory import MemoryOp, Segment

MASK256 = (1 << 256) - 1


class _TraceFull(Exception):
    """The program needs more cycle rows than the current trace has."""


@dataclass
class ExecState:
    pc: int
    stack: List[int] = field(default_factory=list)
    context: int = 0
    # sparse general memory: (context, segment, virtual) -> u256
    memory: Dict[Tuple[int, int, int], int] = field(default_factory=dict)
    # PROVER_INPUT dispatch: callable(fn_tuple, state) -> int
    # (reference generation/prover_input.rs; evm/block.py BlockProverInputs)
    prover_input: object = None
    # privilege flag (reference registers_state.rs is_kernel); execution
    # starts in the kernel and leaves via EXIT_KERNEL
    is_kernel: bool = True
    # gas accounting (reference leaves Operation::Gas/ConsumeGas as todo!(),
    # transition.rs:212-216; implemented here): CONSUME_GAS adds to
    # gas_used, GAS pushes gas_limit - gas_used
    gas_used: int = 0
    gas_limit: int = 0


@dataclass
class KernelExecution:
    cpu_trace: np.ndarray
    memory_ops: List[MemoryOp]
    logic_ops: List[LogicOp]
    arith_ops: List[ArithOp]
    sponge_ops: List[KeccakSpongeOp]
    final_state: ExecState


_USED_COLS = [ch.used for ch in MEM_CHANNELS]


def _wire_channel(trace, j: int, ch, *, is_read: bool, context: int,
                  segment: int, virt: int, value: int) -> None:
    trace[channel_cols(ch), j] = [1, int(is_read), context, segment, virt,
                                  *u256_limbs(value)]


def _channel_mem_ops(trace, j: int, memory_ops: List[MemoryOp]) -> None:
    """Emit one MemoryOp per used GP channel, read back from the wired
    columns so the memory table always matches the CPU-side CTL values
    (reference witness/memory.rs channel timestamps:
    clock * NUM_CHANNELS + 1 + channel)."""
    used = trace[_USED_COLS, j].tolist()
    if not any(used):
        return
    row = trace[:, j].tolist()
    for idx, ch in enumerate(MEM_CHANNELS):
        if not used[idx]:
            continue
        value = 0
        for c in reversed(ch.value):
            value = (value << 32) | row[c]
        memory_ops.append(MemoryOp(
            filter=True,
            timestamp=j * NUM_CHANNELS + MEM_GP_CHANNELS_IDX_START + idx,
            is_read=bool(row[ch.is_read]), context=row[ch.addr_context],
            segment=row[ch.addr_segment], virt=row[ch.addr_virtual],
            value=value))


_BINOPS = {
    0x01: lambda x, y: (x + y) & MASK256,            # ADD
    0x02: lambda x, y: (x * y) & MASK256,            # MUL
    0x03: lambda x, y: (x - y) & MASK256,            # SUB
    0x04: lambda x, y: x // y if y else 0,           # DIV
    0x06: lambda x, y: x % y if y else 0,            # MOD
    0x10: lambda x, y: int(x < y),                   # LT
    0x11: lambda x, y: int(x > y),                   # GT
}
# opcodes that trap to the kernel's syscall jumptable in ANY mode
# (reference witness/transition.rs:27-140 decode; contiguous ranges spelled
# out there are collapsed here)
_SYSCALL_OPS = frozenset(
    [0x00, 0x05, 0x07, 0x0A, 0x0B, 0x12, 0x13, 0x1D, 0x20]
    + list(range(0x30, 0x49))                        # environment ops
    + [0x51, 0x52, 0x53, 0x54, 0x55, 0x59]
    + list(range(0xA0, 0xA5))                        # LOG0..LOG4
    + list(range(0xF0, 0xF6))                        # CREATE..DELEGATECALL
    + [0xFA, 0xFD, 0xFF])
# kernel-only opcodes: invalid (not syscalls) in user mode
_KERNEL_ONLY_OPS = frozenset(
    [0x0C, 0x0D, 0x0E, 0x21, 0x49, 0xF6, 0xF7, 0xF8, 0xF9, 0xFB, 0xFC])
# binops whose result the arithmetic-table CTL binds (one-row ops; DIV/MOD
# are two-row modular ops whose CTL is not wired yet)
_ARITH_CTL = {0x01: "add", 0x02: "mul", 0x03: "sub", 0x10: "lt", 0x11: "gt"}
_LOGIC = {0x16: "and", 0x17: "or", 0x18: "xor"}


def _fill_syscall(trace, j: int, st: ExecState, kernel: Kernel, op: int,
                  pc: int) -> None:
    """Trap to the kernel's syscall handler (reference generate_syscall,
    witness/operation.rs:486-523; constraints cpu.py _eval_syscalls):
    channels 0..2 read the 3-byte handler address from the syscall
    jumptable in kernel code, the push channel writes
    kexit_info = (pc+1) + (is_kernel << 32), and the next row enters the
    handler in kernel mode."""
    from .cpu import OP, PROGRAM_COUNTER, IS_KERNEL_MODE
    from .kernel.assembler import BYTES_PER_OFFSET

    if "syscall_jumptable" not in kernel.global_labels:
        raise NotImplementedError(
            f"opcode {op:#04x} at pc {pc} traps to the syscall jumptable, "
            "but this kernel defines no `syscall_jumptable` label")
    S = st.stack
    trace[OP["syscall"], j] = 1
    jt = kernel.global_labels["syscall_jumptable"]
    addr0 = jt + op * BYTES_PER_OFFSET
    hb = kernel.code[addr0:addr0 + BYTES_PER_OFFSET]
    handler = int.from_bytes(hb, "big")
    for i in range(BYTES_PER_OFFSET):
        _wire_channel(trace, j, MEM_CHANNELS[i], is_read=True, context=0,
                      segment=int(Segment.Code), virt=addr0 + i,
                      value=hb[i])
    info = (pc + 1) + (int(st.is_kernel) << 32)
    _wire_channel(trace, j, MEM_CHANNELS[NUM_GP_CHANNELS - 1],
                  is_read=False, context=st.context,
                  segment=int(Segment.Stack), virt=len(S), value=info)
    S.append(info)
    st.pc = handler
    st.is_kernel = True
    if j + 1 < trace.shape[1]:
        trace[PROGRAM_COUNTER, j + 1] = handler
        trace[IS_KERNEL_MODE, j + 1] = 1


def _fill_cycle(trace, j: int, st: ExecState, kernel: Kernel,
                memory_ops: List[MemoryOp],
                logic_ops: List[LogicOp],
                arith_ops: List[ArithOp],
                sponge_ops: List[KeccakSpongeOp]) -> None:
    """Execute one instruction into trace row j and advance the state."""
    code = kernel.code
    pc = st.pc

    def code_byte(ix: int) -> int:
        """Code fetch: kernel bytecode in kernel mode, the context's Code
        segment in user mode (reference memio.rs code_context)."""
        if st.is_kernel:
            if ix >= len(code):
                raise ValueError(
                    f"pc {ix} ran off the end of the kernel code")
            return code[ix]
        return st.memory.get((st.context, int(Segment.Code), ix), 0) & 0xFF

    op = code_byte(pc)
    S = st.stack

    # stack_len must be in place before fill_cycle_row's bounds-aux witness
    # runs (it checks pops against a zero stack otherwise)
    trace[STACK_LEN, j] = len(S)
    fill_cycle_row(trace, j, op, kernel_mode=st.is_kernel,
                   context=st.context, pc=pc)
    # every cycle reads its opcode byte through the code channel
    # (cpu_stark.rs ctl_data_code_memory)
    memory_ops.append(MemoryOp(
        filter=True, timestamp=j * NUM_CHANNELS + MEM_CODE_CHANNEL_IDX,
        is_read=True, context=int(trace[CODE_CONTEXT, j]),
        segment=int(Segment.Code), virt=pc, value=op))

    if op in _SYSCALL_OPS:
        _fill_syscall(trace, j, st, kernel, op, pc)
        set_stack_bounds_aux(trace, j)
        _channel_mem_ops(trace, j, memory_ops)
        return
    if not st.is_kernel and op in _KERNEL_ONLY_OPS:
        # reference decode: kernel-only opcodes are invalid in user mode
        # (transition.rs InvalidOpcode)
        raise ValueError(
            f"kernel-only opcode {op:#04x} executed in user mode at pc {pc}")

    if 0x60 <= op < 0x80:                            # PUSH1..PUSH32
        n = op - 0x5F
        val = int.from_bytes(bytes(code_byte(pc + 1 + i) for i in range(n)),
                             "big")
        wire_stack_op(trace, j, op, S, context=st.context)  # stack_len + aux
        _wire_channel(trace, j, MEM_CHANNELS[NUM_GP_CHANNELS - 1],
                      is_read=False, context=st.context,
                      segment=int(Segment.Stack), virt=len(S), value=val)
        S.append(val)
        st.pc = pc + 1 + n
    elif 0x80 <= op < 0x90:                          # DUP1..DUP16
        n = op & 0x0F                                # dup_swap.rs:98
        val = S[-1 - n]
        wire_stack_op(trace, j, op, S, context=st.context)
        _wire_channel(trace, j, MEM_CHANNELS[0], is_read=True,
                      context=st.context, segment=int(Segment.Stack),
                      virt=len(S) - 1 - n, value=val)
        _wire_channel(trace, j, MEM_CHANNELS[NUM_GP_CHANNELS - 1],
                      is_read=False, context=st.context,
                      segment=int(Segment.Stack), virt=len(S), value=val)
        S.append(val)
        st.pc = pc + 1
    elif 0x90 <= op < 0xA0:                          # SWAP1..SWAP16
        d = (op & 0x0F) + 1                          # dup_swap.rs:160
        top, deep = S[-1], S[-1 - d]
        wire_stack_op(trace, j, op, S, context=st.context)
        seg = int(Segment.Stack)
        _wire_channel(trace, j, MEM_CHANNELS[0], is_read=True,
                      context=st.context, segment=seg, virt=len(S) - 1,
                      value=top)
        _wire_channel(trace, j, MEM_CHANNELS[1], is_read=True,
                      context=st.context, segment=seg, virt=len(S) - 1 - d,
                      value=deep)
        _wire_channel(trace, j, MEM_CHANNELS[NUM_GP_CHANNELS - 2],
                      is_read=False, context=st.context, segment=seg,
                      virt=len(S) - 1 - d, value=top)
        _wire_channel(trace, j, MEM_CHANNELS[NUM_GP_CHANNELS - 1],
                      is_read=False, context=st.context, segment=seg,
                      virt=len(S) - 1, value=deep)
        S[-1], S[-1 - d] = deep, top
        st.pc = pc + 1
    elif op in _BINOPS:
        x, y = S[-1], S[-2]
        r = _BINOPS[op](x, y)
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        if op in _ARITH_CTL:
            # the arithmetic CTL reads the result from channel 2's value
            # columns (cpu.py ctl_data_arithmetic); the channel stays
            # disabled, like the logic CTL's
            set_u256_channel(trace, j, 2, r)
            arith_ops.append(ArithOp(_ARITH_CTL[op], x, y))
        elif op == 0x04:                             # DIV: modular-path row
            arith_ops.append(ArithOp("div", x, 0, modulus=y))
        elif op == 0x06:                             # MOD
            arith_ops.append(ArithOp("mod", x, 0, modulus=y))
        del S[-2:]
        S.append(r)
        st.pc = pc + 1
    elif op in _LOGIC:                               # AND / OR / XOR
        x, y = S[-1], S[-2]
        lop = LogicOp(_LOGIC[op], x, y)
        r = lop.result
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        # the logic CTL reads the result from channel 2's value columns
        # (cpu.py ctl_data_logic); the channel itself stays disabled
        set_u256_channel(trace, j, 2, r)
        logic_ops.append(lop)
        del S[-2:]
        S.append(r)
        st.pc = pc + 1
    elif op in (0x1B, 0x1C):                         # SHL / SHR
        shift_amt, value = S[-1], S[-2]
        if shift_amt >= 256:
            r = 0
        elif op == 0x1B:
            r = (value << shift_amt) & MASK256
        else:
            r = value >> shift_amt
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        # channel 2 reads 2^disp from the kernel shift table when the
        # displacement fits 32 bits (cpu.py _eval_shift, shift.rs:11-60)
        if shift_amt < (1 << 32):
            two_exp = st.memory.get((0, int(Segment.ShiftTable), shift_amt))
            if two_exp is None:
                raise ValueError(
                    "SHL/SHR executed before Segment::ShiftTable was "
                    "initialized — run kernel.stdlib.SHIFT_TABLE_INIT first")
            _wire_channel(trace, j, MEM_CHANNELS[2], is_read=True, context=0,
                          segment=int(Segment.ShiftTable), virt=shift_amt,
                          value=two_exp)
        else:
            from .cpu import GENERAL
            hi_sum = sum((shift_amt >> (32 * i)) & 0xFFFFFFFF
                         for i in range(1, VALUE_LIMBS)) % gl.P
            trace[GENERAL[0], j] = pow(hi_sum, gl.P - 2, gl.P)
        del S[-2:]
        S.append(r)
        st.pc = pc + 1
    elif op in (0x08, 0x09):                         # ADDMOD / MULMOD
        a, b, N = S[-1], S[-2], S[-3]
        if N == 0:
            r = 0
        elif op == 0x08:
            r = (a + b) % N
        else:
            r = (a * b) % N
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        # ternary arithmetic CTL: (a, b, N) pop through channels 0..2 and
        # r through the push channel (cpu.py ctl_data_arithmetic_ternary)
        arith_ops.append(ArithOp("addmod" if op == 0x08 else "mulmod",
                                 a, b, modulus=N))
        del S[-3:]
        S.append(r)
        st.pc = pc + 1
    elif op == 0x1A:                                 # BYTE
        i_b, x = S[-1], S[-2]
        r = (x >> (8 * (31 - i_b))) & 0xFF if i_b < 32 else 0
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        del S[-2:]
        S.append(r)
        st.pc = pc + 1
    elif op == 0x19:                                 # NOT
        x = S[-1]
        r = x ^ MASK256
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        S[-1] = r
        st.pc = pc + 1
    elif op == 0x14:                                 # EQ
        x, y = S[-1], S[-2]
        r = int(x == y)
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        set_eq_iszero_values(trace, j, x, y)
        del S[-2:]
        S.append(r)
        st.pc = pc + 1
    elif op == 0x15:                                 # ISZERO
        x = S[-1]
        r = int(x == 0)
        wire_stack_op(trace, j, op, S, push_value=r, context=st.context)
        set_eq_iszero_values(trace, j, x, 0)
        S[-1] = r
        st.pc = pc + 1
    elif op == 0x50:                                 # POP
        wire_stack_op(trace, j, op, S, context=st.context)
        S.pop()
        st.pc = pc + 1
    elif op == 0x21:                                 # KECCAK_GENERAL
        from ..hash.keccak import keccak256
        from .cpu import IS_KECCAK_SPONGE
        ctx, seg, virt, length = S[-1], S[-2], S[-3], S[-4]
        data = bytes(st.memory.get((ctx, seg, virt + i), 0) & 0xFF
                     for i in range(length))
        digest = keccak256(data)
        # pushed as the sponge's u32-limb encoding (little-endian), the
        # same encoding the sponge CTL exposes and the bootstrap row uses
        value = int.from_bytes(digest, "little")
        wire_stack_op(trace, j, op, S, push_value=value, context=st.context)
        trace[IS_KECCAK_SPONGE, j] = 1
        sponge_ops.append(KeccakSpongeOp(
            context=ctx, segment=seg, virt=virt,
            timestamp=j * NUM_CHANNELS, input=data))
        del S[-4:]
        S.append(value)
        st.pc = pc + 1
    elif op == 0x49:                                 # PROVER_INPUT
        if st.prover_input is None:
            raise ValueError("PROVER_INPUT executed without a prover-input "
                             "provider (pass prover_input_factory)")
        fn = kernel.prover_inputs.get(pc)
        if fn is None:
            raise ValueError(f"no PROVER_INPUT fn recorded at pc {pc}")
        val = int(st.prover_input(fn, st)) & MASK256
        wire_stack_op(trace, j, op, S, push_value=val, context=st.context)
        S.append(val)
        st.pc = pc + 1
    elif op == 0x58:                                 # GETPC
        wire_stack_op(trace, j, op, S, push_value=pc, context=st.context)
        S.append(pc)
        st.pc = pc + 1
    elif op == 0x5B:                                 # JUMPDEST
        wire_stack_op(trace, j, op, S, context=st.context)
        st.pc = pc + 1
    elif op in (0x56, 0x57):                         # JUMP / JUMPI
        dst = S[-1]
        cond = 1 if op == 0x56 else S[-2]
        wire_stack_op(trace, j, op, S, context=st.context)
        if op == 0x56:
            set_u256_channel(trace, j, 1, 1)         # jumps.rs: cond pinned 1
        should = int(cond != 0)
        trace[JUMPS_SHOULD_JUMP, j] = should
        cond_sum = sum((cond >> (32 * i)) & 0xFFFFFFFF
                       for i in range(VALUE_LIMBS)) % gl.P
        trace[JUMPS_COND_SUM_PINV, j] = \
            pow(cond_sum, gl.P - 2, gl.P) if cond_sum else 0
        # jumpdest-bit channel: unused in kernel mode, but its address and
        # claimed flag value are still constrained; taken USER-mode jumps
        # actually read the bit (jumps.rs:97-120), so the jumpdest-analysis
        # pass must have stored a 1 there
        ch = MEM_CHANNELS[NUM_GP_CHANNELS - 1]
        trace[ch.value[0], j] = 1
        trace[ch.is_read, j] = 1
        trace[ch.addr_context, j] = st.context
        trace[ch.addr_segment, j] = int(Segment.JumpdestBits)
        trace[ch.addr_virtual, j] = dst
        if should and not st.is_kernel:
            bit = st.memory.get(
                (st.context, int(Segment.JumpdestBits), dst), 0)
            if bit != 1:
                raise ValueError(
                    f"user-mode jump to {dst} without a jumpdest bit")
            trace[ch.used, j] = 1
        del S[-2 if op == 0x57 else -1:]
        st.pc = dst if should else pc + 1
    elif op == 0xF6:                                 # GET_CONTEXT
        wire_stack_op(trace, j, op, S, push_value=st.context,
                      context=st.context)
        S.append(st.context)
        st.pc = pc + 1
    elif op == 0xF7:                                 # SET_CONTEXT
        wire_stack_op(trace, j, op, S, context=st.context)
        st.context = S.pop()
        st.pc = pc + 1
    elif op == 0xFB:                                 # MLOAD_GENERAL
        ctx, seg, virt = S[-1], S[-2], S[-3]
        val = st.memory.get((ctx, seg, virt), 0)
        wire_stack_op(trace, j, op, S, push_value=val, context=st.context)
        _wire_channel(trace, j, MEM_CHANNELS[3], is_read=True, context=ctx,
                      segment=seg, virt=virt, value=val)
        del S[-3:]
        S.append(val)
        st.pc = pc + 1
    elif op == 0xFC:                                 # MSTORE_GENERAL
        ctx, seg, virt, val = S[-1], S[-2], S[-3], S[-4]
        wire_stack_op(trace, j, op, S, context=st.context)
        _wire_channel(trace, j, MEM_CHANNELS[4], is_read=False, context=ctx,
                      segment=seg, virt=virt, value=val)
        st.memory[(ctx, seg, virt)] = val
        del S[-4:]
        st.pc = pc + 1
    elif op == 0xF9:                                 # EXIT_KERNEL
        # pops kexit_info = pc' + (is_kernel' << 32); the jump constraints
        # read the popped limbs into the next row's (pc, privilege)
        # (cpu.py _eval_jumps; reference generate_exit_kernel,
        # operation.rs:553-580)
        val = S[-1]
        wire_stack_op(trace, j, op, S, context=st.context)
        del S[-1]
        new_pc = val & 0xFFFFFFFF
        new_kernel = (val >> 32) & 0xFFFFFFFF
        if new_kernel not in (0, 1):
            raise ValueError(f"EXIT_KERNEL kexit_info has non-boolean "
                             f"kernel flag {new_kernel}")
        st.pc = new_pc
        st.is_kernel = bool(new_kernel)
        if j + 1 < trace.shape[1]:
            trace[PROGRAM_COUNTER, j + 1] = new_pc
            trace[IS_KERNEL_MODE, j + 1] = new_kernel
    elif op == 0x5A:                                 # GAS
        # the reference leaves Operation::Gas as todo!()
        # (witness/transition.rs:212); here it pushes the remaining gas
        remaining = max(st.gas_limit - st.gas_used, 0)
        wire_stack_op(trace, j, op, S, push_value=remaining,
                      context=st.context)
        S.append(remaining)
        st.pc = pc + 1
    elif op == 0xF8:                                 # CONSUME_GAS (kernel)
        # reference todo!() (witness/transition.rs:216); pops an amount and
        # adds it to gas_used
        amount = S[-1]
        wire_stack_op(trace, j, op, S, context=st.context)
        del S[-1]
        st.gas_used += amount
        st.pc = pc + 1
    else:
        raise NotImplementedError(
            f"opcode {op:#04x} at pc {pc} is not supported by the execution "
            "witness generator yet")

    set_stack_bounds_aux(trace, j)
    _channel_mem_ops(trace, j, memory_ops)


def _generate(kernel: Kernel, n_rows: int,
              prover_input_factory=None) -> KernelExecution:
    labels = kernel.global_labels
    boot_trace, memory_ops, sponge_ops = \
        generate_bootstrap_kernel(kernel, min_rows=2)
    nb = -(-len(kernel.code) // NUM_GP_CHANNELS) + 1
    if nb + 1 >= n_rows:
        raise _TraceFull
    trace = np.zeros((NUM_CPU_COLUMNS, n_rows), dtype=np.uint64)
    trace[:, :nb] = boot_trace[:, :nb]
    trace[CLOCK] = np.arange(n_rows, dtype=np.uint64)

    st = ExecState(pc=labels["main"],
                   prover_input=(prover_input_factory()
                                 if prover_input_factory else None))
    logic_ops: List[LogicOp] = []
    arith_ops: List[ArithOp] = []
    halt_pcs = {labels["halt_pc0"], labels["halt_pc1"]}
    for j in range(nb, n_rows):
        _fill_cycle(trace, j, st, kernel, memory_ops, logic_ops, arith_ops,
                    sponge_ops)
    if int(trace[PROGRAM_COUNTER, n_rows - 1]) not in halt_pcs:
        raise _TraceFull
    return KernelExecution(cpu_trace=trace, memory_ops=memory_ops,
                           logic_ops=logic_ops, arith_ops=arith_ops,
                           sponge_ops=sponge_ops, final_state=st)


def generate_kernel_execution(kernel: Kernel, min_rows: int = 8,
                              prover_input_factory=None) -> KernelExecution:
    """Execute `kernel` from its ``main`` label and return the CPU trace
    plus the memory/logic/sponge witness it implies.  The kernel must define
    ``main``, ``halt_pc0`` and ``halt_pc1`` labels, with the halt loop
    shaped so that spinning it keeps all constraints satisfied, e.g.::

        GLOBAL halt_pc0:
            PUSH halt_pc0
        GLOBAL halt_pc1:
            JUMP
    """
    for k in ("main", "halt_pc0", "halt_pc1"):
        if k not in kernel.global_labels:
            raise ValueError(f"kernel is missing the `{k}` label required "
                             "for execution proofs")
    n_rows = max(min_rows, 8)
    n_rows = 1 << (n_rows - 1).bit_length()
    while True:
        try:
            return _generate(kernel, n_rows, prover_input_factory)
        except _TraceFull:
            n_rows *= 2
