"""The port's copy of plonky2_tpu/evm/kernel/interpreter.py.

Offline kernel interpreter for testing assembled code
(reference evm/src/cpu/kernel/interpreter.rs — same role: execute kernel
bytecode natively, without the prover, to unit-test asm routines)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

U256 = 1 << 256
MASK = U256 - 1
SIGN_BIT = 1 << 255


class KernelPanic(Exception):
    pass


def _signed(x: int) -> int:
    return x - U256 if x & SIGN_BIT else x


@dataclass
class InterpreterState:
    stack: List[int] = field(default_factory=list)
    memory: bytearray = field(default_factory=bytearray)
    # segmented kernel memory (context, segment, virtual) -> u256, used by
    # MLOAD/MSTORE_GENERAL / KECCAK_GENERAL (reference interpreter.rs keeps
    # the same map for its kernel-routine tests)
    segmem: Dict = field(default_factory=dict)
    gas_used: int = 0
    prover_input: object = None    # callable(fn_tuple, state) -> int
    pc: int = 0
    running: bool = True
    jumped: bool = False


def run_with_kernel(kernel, initial_offset: int, initial_stack: List[int],
                    max_steps: int = 1_000_000, segmem=None,
                    prover_input=None,
                    halt_offsets=()) -> InterpreterState:
    """Execute from `initial_offset` until STOP or a pc in `halt_offsets`
    (reference interpreter.rs run_with_kernel / halt_offsets).
    `initial_stack` lists the stack bottom-first, matching the reference's
    convention."""
    st = InterpreterState(stack=list(initial_stack), pc=initial_offset,
                          segmem=dict(segmem or {}),
                          prover_input=prover_input)
    code = kernel.code
    steps = 0
    while st.running and st.pc < len(code):
        if st.pc in halt_offsets:
            break
        steps += 1
        if steps > max_steps:
            raise RuntimeError("interpreter step limit exceeded")
        op = code[st.pc]
        st.jumped = False
        if op == 0x49:                          # PROVER_INPUT
            fn = kernel.prover_inputs.get(st.pc)
            assert fn is not None, f"no PROVER_INPUT fn at pc {st.pc}"
            assert st.prover_input is not None, "no prover_input provider"
            class _S:                            # adapter: .stack for block.py
                pass
            _s = _S(); _s.stack = st.stack; _s.memory = st.segmem
            _push(st, int(st.prover_input(fn, _s)) & MASK)
            st.pc += 1
            continue
        _step(st, op, code)
        if not st.jumped:
            if 0x60 <= op < 0x80:
                st.pc += 2 + (op - 0x60)
            else:
                st.pc += 1
    return st


def _pop(st: InterpreterState) -> int:
    return st.stack.pop()


def _push(st: InterpreterState, v: int) -> None:
    st.stack.append(v & MASK)


def _mem_read(st, offset, n):
    end = offset + n
    if end > len(st.memory):
        st.memory.extend(bytearray(end - len(st.memory)))
    return int.from_bytes(st.memory[offset:end], "big")


def _mem_write(st, offset, n, v):
    end = offset + n
    if end > len(st.memory):
        st.memory.extend(bytearray(end - len(st.memory)))
    st.memory[offset:end] = v.to_bytes(n, "big")


def _step(st: InterpreterState, op: int, code: bytes) -> None:
    S = st.stack
    if 0x60 <= op < 0x80:                       # PUSH1..PUSH32
        n = op - 0x60 + 1
        _push(st, int.from_bytes(code[st.pc + 1:st.pc + 1 + n], "big"))
        return
    if 0x80 <= op < 0x90:                       # DUP1..DUP16
        _push(st, S[-(op - 0x80 + 1)])
        return
    if 0x90 <= op < 0xA0:                       # SWAP1..SWAP16
        d = op - 0x90 + 1
        S[-1], S[-1 - d] = S[-1 - d], S[-1]
        return

    if op == 0x00:                              # STOP
        st.running = False
    elif op == 0x01:
        _push(st, _pop(st) + _pop(st))
    elif op == 0x02:
        _push(st, _pop(st) * _pop(st))
    elif op == 0x03:
        x = _pop(st); _push(st, x - _pop(st))
    elif op == 0x04:
        x, y = _pop(st), _pop(st); _push(st, x // y if y else 0)
    elif op == 0x05:                            # SDIV
        x, y = _signed(_pop(st)), _signed(_pop(st))
        _push(st, 0 if y == 0 else abs(x) // abs(y) *
              (1 if (x >= 0) == (y >= 0) else -1))
    elif op == 0x06:
        x, y = _pop(st), _pop(st); _push(st, x % y if y else 0)
    elif op == 0x07:                            # SMOD
        x, y = _signed(_pop(st)), _signed(_pop(st))
        _push(st, 0 if y == 0 else (abs(x) % abs(y)) * (1 if x >= 0 else -1))
    elif op == 0x08:                            # ADDMOD
        x, y, m = _pop(st), _pop(st), _pop(st)
        _push(st, (x + y) % m if m else 0)
    elif op == 0x09:                            # MULMOD
        x, y, m = _pop(st), _pop(st), _pop(st)
        _push(st, (x * y) % m if m else 0)
    elif op == 0x0A:                            # EXP
        x, y = _pop(st), _pop(st); _push(st, pow(x, y, U256))
    elif op == 0x0B:                            # SIGNEXTEND
        b, x = _pop(st), _pop(st)
        if b < 31:
            bit = 8 * b + 7
            if x & (1 << bit):
                x |= MASK ^ ((1 << (bit + 1)) - 1)
            else:
                x &= (1 << (bit + 1)) - 1
        _push(st, x)
    elif op == 0x10:
        x = _pop(st); _push(st, int(x < _pop(st)))
    elif op == 0x11:
        x = _pop(st); _push(st, int(x > _pop(st)))
    elif op == 0x12:                            # SLT
        x = _signed(_pop(st)); _push(st, int(x < _signed(_pop(st))))
    elif op == 0x13:                            # SGT
        x = _signed(_pop(st)); _push(st, int(x > _signed(_pop(st))))
    elif op == 0x14:
        _push(st, int(_pop(st) == _pop(st)))
    elif op == 0x15:
        _push(st, int(_pop(st) == 0))
    elif op == 0x16:
        _push(st, _pop(st) & _pop(st))
    elif op == 0x17:
        _push(st, _pop(st) | _pop(st))
    elif op == 0x18:
        _push(st, _pop(st) ^ _pop(st))
    elif op == 0x19:
        _push(st, ~_pop(st))
    elif op == 0x1A:                            # BYTE
        i, x = _pop(st), _pop(st)
        _push(st, (x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
    elif op == 0x1B:                            # SHL
        s, x = _pop(st), _pop(st); _push(st, x << s if s < 256 else 0)
    elif op == 0x1C:                            # SHR
        s, x = _pop(st), _pop(st); _push(st, x >> s if s < 256 else 0)
    elif op == 0x1D:                            # SAR
        s, x = _pop(st), _signed(_pop(st))
        _push(st, x >> s if s < 256 else (0 if x >= 0 else MASK))
    elif op == 0x50:
        _pop(st)
    elif op == 0x51:                            # MLOAD
        _push(st, _mem_read(st, _pop(st), 32))
    elif op == 0x52:                            # MSTORE
        off, v = _pop(st), _pop(st); _mem_write(st, off, 32, v)
    elif op == 0x53:                            # MSTORE8
        off, v = _pop(st), _pop(st); _mem_write(st, off, 1, v & 0xFF)
    elif op == 0x56:                            # JUMP
        st.pc = _pop(st)
        st.jumped = True
    elif op == 0x57:                            # JUMPI
        dest, cond = _pop(st), _pop(st)
        if cond:
            st.pc = dest
            st.jumped = True
    elif op == 0x58:                            # GETPC
        _push(st, st.pc)
    elif op == 0x5B:                            # JUMPDEST
        pass
    elif op == 0x21:                            # KECCAK_GENERAL
        from ...hash.keccak import keccak256
        ctx, seg, virt, length = _pop(st), _pop(st), _pop(st), _pop(st)
        data = bytes(st.segmem.get((ctx, seg, virt + i), 0) & 0xFF
                     for i in range(length))
        _push(st, int.from_bytes(keccak256(data), "little"))
    elif op == 0xF8:                            # CONSUME_GAS
        st.gas_used += _pop(st)
    elif op == 0xFB:                            # MLOAD_GENERAL
        ctx, seg, virt = _pop(st), _pop(st), _pop(st)
        _push(st, st.segmem.get((ctx, seg, virt), 0))
    elif op == 0xFC:                            # MSTORE_GENERAL
        ctx, seg, virt, val = _pop(st), _pop(st), _pop(st), _pop(st)
        st.segmem[(ctx, seg, virt)] = val
    elif op == 0xA5:                            # PANIC
        raise KernelPanic("kernel panic")
    else:
        raise NotImplementedError(f"opcode {op:#x} not supported by the "
                                  "test interpreter")
