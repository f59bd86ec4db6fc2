"""The port's copy of plonky2_tpu/evm/cpu.py; its witness helpers cache
each opcode's decoded flags and the stack-bound inverses and write a
row's decode columns and a channel's columns with one numpy op each (the
same trace).  ``CpuStark.eval`` is traced into a constraint program for
K6 (stark/quotient_program.py) like every STARK's.

CPU table — kernel-bootstrap phase
(reference evm/src/cpu/{columns,membus,bootstrap_kernel,cpu_stark}.rs).

The bootstrap phase hashes the kernel code while writing it to memory: each
row writes NUM_GP_CHANNELS code bytes through the memory channels, and the
final bootstrap row exposes a keccak-sponge lookup of the whole code whose
digest is constrained to equal the kernel's precomputed hash.

Channel usage on the final row (we fix two inconsistencies in the
reference: bootstrap_kernel.rs:44-51 writes the digest to channel 4 while
ctl_data_keccak_sponge reads channel 3, and stores the clock where the
sponge expects the length):
  ch0.value[0] = context, ch1.value[0] = segment, ch2.value[0] = virt,
  ch3.value[0] = len, ch4.value[..8] = code hash (8 u32 limbs).

Cycle-row constraint stages implemented: decode (opcode bits -> one-hot
instruction flags with kernel gating), simple logic (NOT/EQ/ISZERO), GETPC,
jumps (JUMP/JUMPI/EXIT_KERNEL), context ops, fp254 modulus pinning, shift
table gating, dup/swap, memio (MLOAD/MSTORE_GENERAL), syscall dispatch,
control flow (native pc increment; kernel start/halt endgame gated on halt
labels), per-op stack behaviors and stack bounds.  The full-execution
witness generator that runs a program into these rows lives in
`generation.py` (reference witness/ + generation/).  The arithmetic-table
CTL is live: ADD/MUL/SUB/LT/GT (and the modular ops) look their
(input0, input1, result) triples up in the arithmetic table — see
``ctl_arithmetic_rows`` below and `all_stark.py`.  Gas accounting is
live: the GAS column is constrained row-to-row against the per-opcode
cost table (see ``gas`` stage below and `generation.py`)."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..field import goldilocks as gl
from ..stark.stark import Stark
from .cross_table_lookup import Column
from .kernel.assembler import Kernel
from .memory import MemoryOp, Segment  # noqa: F401
from .keccak_sponge import KeccakSpongeOp

NUM_GP_CHANNELS = 5                      # membus.rs:10
MEM_CODE_CHANNEL_IDX = 0                 # cpu_stark.rs:60-61
MEM_GP_CHANNELS_IDX_START = 1
NUM_CHANNELS = 1 + NUM_GP_CHANNELS       # code channel + GP channels
VALUE_LIMBS = 8

# --- column layout (reference cpu/columns/mod.rs:37-80, ops.rs:9-58) ------

_c = 0


def _col() -> int:
    global _c
    i = _c
    _c += 1
    return i


IS_BOOTSTRAP_KERNEL = _col()
IS_CPU_CYCLE = _col()
CONTEXT = _col()
CODE_CONTEXT = _col()
PROGRAM_COUNTER = _col()
STACK_LEN = _col()
STACK_LEN_BOUNDS_AUX = _col()
IS_KERNEL_MODE = _col()

OP_NAMES = [
    "add", "mul", "sub", "div", "mod_", "addmod", "mulmod", "addfp254",
    "mulfp254", "subfp254", "lt", "gt", "eq", "iszero", "and_", "or_",
    "xor", "not_", "byte", "shl", "shr", "keccak_general", "prover_input",
    "pop", "jump", "jumpi", "pc", "gas", "jumpdest", "push", "dup", "swap",
    "get_context", "set_context", "consume_gas", "exit_kernel",
    "mload_general", "mstore_general", "syscall",
]
OP = {name: _col() for name in OP_NAMES}
OPCODE_BITS = [_col() for _ in range(8)]
IS_KECCAK_SPONGE = _col()
# shared "general" columns (union of per-op views, general.rs:87-114)
NUM_SHARED_COLUMNS = 8
GENERAL = [_col() for _ in range(NUM_SHARED_COLUMNS)]
# the jumps view of the general union (general.rs:99-104)
JUMPS_SHOULD_JUMP = GENERAL[0]
JUMPS_COND_SUM_PINV = GENERAL[1]
CLOCK = _col()


@dataclass(frozen=True)
class MemChannel:
    used: int
    is_read: int
    addr_context: int
    addr_segment: int
    addr_virtual: int
    value: Tuple[int, ...]


def _channel() -> MemChannel:
    return MemChannel(used=_col(), is_read=_col(), addr_context=_col(),
                      addr_segment=_col(), addr_virtual=_col(),
                      value=tuple(_col() for _ in range(VALUE_LIMBS)))


MEM_CHANNELS = [_channel() for _ in range(NUM_GP_CHANNELS)]
NUM_CPU_COLUMNS = _c

# the columns the witness writes or reads together on a row
_DECODE_COLS = np.array(OPCODE_BITS + [OP[name] for name in OP_NAMES
                                       if name != "syscall"])
_BOUNDS_COLS = np.array([OP["pop"], OP["pc"], OP["dup"], STACK_LEN,
                         IS_KERNEL_MODE])


def channel_cols(ch: MemChannel) -> list:
    """A channel's used, is_read, context, segment, virtual and value
    columns, in that order."""
    return [ch.used, ch.is_read, ch.addr_context, ch.addr_segment,
            ch.addr_virtual, *ch.value]


_CHANNEL_COLS = [channel_cols(ch) for ch in MEM_CHANNELS]

# Opcode blocks: (block start, log2(block length), kernel-only, flag name)
# (reference decode.rs:25-67). Each block is aligned and power-of-2 sized.
OPCODE_BLOCKS = [
    (0x01, 0, False, "add"), (0x02, 0, False, "mul"), (0x03, 0, False, "sub"),
    (0x04, 0, False, "div"), (0x06, 0, False, "mod_"),
    (0x08, 0, False, "addmod"), (0x09, 0, False, "mulmod"),
    (0x0C, 0, True, "addfp254"), (0x0D, 0, True, "mulfp254"),
    (0x0E, 0, True, "subfp254"), (0x10, 0, False, "lt"),
    (0x11, 0, False, "gt"), (0x14, 0, False, "eq"),
    (0x15, 0, False, "iszero"), (0x16, 0, False, "and_"),
    (0x17, 0, False, "or_"), (0x18, 0, False, "xor"),
    (0x19, 0, False, "not_"), (0x1A, 0, False, "byte"),
    (0x1B, 0, False, "shl"), (0x1C, 0, False, "shr"),
    (0x21, 0, True, "keccak_general"), (0x49, 0, True, "prover_input"),
    (0x50, 0, False, "pop"), (0x56, 0, False, "jump"),
    (0x57, 0, False, "jumpi"), (0x58, 0, False, "pc"),
    (0x5A, 0, False, "gas"), (0x5B, 0, False, "jumpdest"),
    (0x60, 5, False, "push"), (0x80, 4, False, "dup"),
    (0x90, 4, False, "swap"), (0xF6, 0, True, "get_context"),
    (0xF7, 0, True, "set_context"), (0xF8, 0, True, "consume_gas"),
    (0xF9, 0, True, "exit_kernel"), (0xFB, 0, True, "mload_general"),
    (0xFC, 0, True, "mstore_general"),
]


def invalid_opcodes_user() -> bytes:
    """Little-endian bitfield of user-invalid opcodes
    (reference decode.rs:69-94)."""
    res = bytearray([0xFF] * 32)
    for start, lb, kernel_only, _ in OPCODE_BLOCKS:
        if kernel_only:
            continue
        for op in range(start, start + (1 << lb)):
            res[op // 8] &= ~(1 << (op % 8)) & 0xFF
    return bytes(res)


# --- CTL columns (reference cpu_stark.rs:23-112) --------------------------

def _mem_time_and_channel(channel: int) -> Column:
    return Column([(CLOCK, NUM_CHANNELS)], constant=channel)


def ctl_data_keccak_sponge() -> List[Column]:
    cols = Column.singles([MEM_CHANNELS[0].value[0], MEM_CHANNELS[1].value[0],
                           MEM_CHANNELS[2].value[0], MEM_CHANNELS[3].value[0]])
    cols.append(Column([(CLOCK, NUM_CHANNELS)]))
    cols += Column.singles(MEM_CHANNELS[4].value)
    return cols


def ctl_filter_keccak_sponge() -> Column:
    return Column.single(IS_KECCAK_SPONGE)


def ctl_data_logic() -> List[Column]:
    res = Column.singles([OP["and_"], OP["or_"], OP["xor"]])
    for ch in (0, 1, 2):
        res += Column.singles(MEM_CHANNELS[ch].value)
    return res


def ctl_filter_logic() -> Column:
    return Column.sum_cols([OP["and_"], OP["or_"], OP["xor"]])


def ctl_data_arithmetic() -> List[Column]:
    """Operands in channels 0/1, result in channel 2's value columns (the
    stack behaviors disable that channel, so — like the logic CTL — its
    value columns are free to carry the lookup payload; the column order
    mirrors arithmetic.ctl_data)."""
    cols = Column.singles([OP["add"], OP["mul"], OP["sub"],
                           OP["lt"], OP["gt"]])
    for ch in (0, 1, 2):
        cols += Column.singles(MEM_CHANNELS[ch].value)
    return cols


def ctl_filter_arithmetic() -> Column:
    return Column.sum_cols([OP["add"], OP["mul"], OP["sub"],
                            OP["lt"], OP["gt"]])


def ctl_data_arithmetic_ternary() -> List[Column]:
    """ADDMOD/MULMOD: operands (a, b, m) pop through channels 0..2 and the
    result through the push channel — all four already constrained against
    the stack, so the lookup payload is fully stack-bound (the column order
    mirrors arithmetic.ctl_data_ternary)."""
    cols = Column.singles([OP["addmod"], OP["mulmod"]])
    for ch in (0, 1, 2, NUM_GP_CHANNELS - 1):
        cols += Column.singles(MEM_CHANNELS[ch].value)
    return cols


def ctl_filter_arithmetic_ternary() -> Column:
    return Column.sum_cols([OP["addmod"], OP["mulmod"]])


def _ctl_data_divmod() -> List[Column]:
    cols: List[Column] = []
    for ch in (0, 1, NUM_GP_CHANNELS - 1):
        cols += Column.singles(MEM_CHANNELS[ch].value)
    return cols


def ctl_data_arithmetic_div() -> List[Column]:
    """DIV: (numerator, denominator) in channels 0/1, quotient in the push
    channel (mirrors arithmetic.ctl_data_div)."""
    return _ctl_data_divmod()


def ctl_filter_arithmetic_div() -> Column:
    return Column.single(OP["div"])


def ctl_data_arithmetic_mod() -> List[Column]:
    """MOD: (value, modulus) in channels 0/1, residue in the push channel
    (mirrors arithmetic.ctl_data_mod)."""
    return _ctl_data_divmod()


def ctl_filter_arithmetic_mod() -> Column:
    return Column.single(OP["mod_"])


def ctl_data_code_memory() -> List[Column]:
    cols = [Column.constant_col(1),
            Column.single(CODE_CONTEXT),
            Column.constant_col(int(Segment.Code)),
            Column.single(PROGRAM_COUNTER),
            Column.le_bits(OPCODE_BITS)]
    cols += [Column.constant_col(0)] * (VALUE_LIMBS - 1)
    cols.append(_mem_time_and_channel(MEM_CODE_CHANNEL_IDX))
    return cols


def ctl_filter_code_memory() -> Column:
    return Column.single(IS_CPU_CYCLE)


def ctl_data_gp_memory(channel: int) -> List[Column]:
    ch = MEM_CHANNELS[channel]
    cols = Column.singles([ch.is_read, ch.addr_context, ch.addr_segment,
                           ch.addr_virtual])
    cols += Column.singles(ch.value)
    cols.append(_mem_time_and_channel(MEM_GP_CHANNELS_IDX_START + channel))
    return cols


def ctl_filter_gp_memory(channel: int) -> Column:
    return Column.single(MEM_CHANNELS[channel].used)


# --- witness generation ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _decoded(opcode: int, kernel_mode: bool) -> tuple:
    """(flag name, value) of every instruction flag, in OPCODE_BLOCKS
    order (reference decode.rs:96-137 generate)."""
    return tuple((name, int((opcode >> lb) == (start >> lb)
                            and (not kernel_only or kernel_mode)))
                 for start, lb, kernel_only, name in OPCODE_BLOCKS)


def decode_flags(opcode: int, kernel_mode: bool) -> dict:
    """Instruction flags implied by an opcode byte
    (reference decode.rs:96-137 generate)."""
    return dict(_decoded(opcode, bool(kernel_mode)))


@functools.lru_cache(maxsize=None)
def _decoded_row(opcode: int, kernel_mode: bool) -> np.ndarray:
    """The opcode's bits, then its flags in OPCODE_BLOCKS order: the
    values of _DECODE_COLS on its cycle row."""
    row = np.array([(opcode >> i) & 1 for i in range(8)]
                   + [v for _, v in _decoded(opcode, kernel_mode)],
                   dtype=np.uint64)
    row.setflags(write=False)
    return row


@functools.lru_cache(maxsize=None)
def _op_name(opcode: int):
    """The flag an opcode raises in kernel mode, or None."""
    return next((n for n, v in _decoded(opcode, True) if v), None)


@functools.lru_cache(maxsize=1 << 16)
def _inverse(x: int) -> int:
    return pow(x, gl.P - 2, gl.P)


def fill_cycle_row(trace: np.ndarray, j: int, opcode: int,
                   kernel_mode: bool = True, context: int = 0,
                   pc: int = 0) -> None:
    """Populate the decode-related columns of a cycle row (witness side of
    the decode constraints; full execution semantics land with the stack
    constraint stage).  Also seeds the next row's pc/privilege with the
    native-instruction defaults (pc+1, same mode); callers overwrite them
    for jumps/syscalls."""
    trace[IS_CPU_CYCLE, j] = 1
    trace[IS_KERNEL_MODE, j] = int(kernel_mode)
    trace[CONTEXT, j] = context
    trace[CODE_CONTEXT, j] = 0 if kernel_mode else context
    trace[PROGRAM_COUNTER, j] = pc
    if j + 1 < trace.shape[1]:
        trace[PROGRAM_COUNTER, j + 1] = pc + 1
        trace[IS_KERNEL_MODE, j + 1] = int(kernel_mode)
    trace[_DECODE_COLS, j] = _decoded_row(opcode, bool(kernel_mode))
    set_stack_bounds_aux(trace, j)


def set_stack_bounds_aux(trace: np.ndarray, j: int) -> None:
    """Witness stack_len_bounds_aux (reference stack_bounds.rs:38-59).
    Call after the flags and stack_len of row j are final."""
    pop, pc, dup, stack_len, kernel = trace[_BOUNDS_COLS, j].tolist()
    check_under = pop
    check_over = pc + dup
    no_check = 1 - check_under - check_over
    disallowed = (check_over * 1024 - no_check) % gl.P
    diff = (stack_len - disallowed) % gl.P
    user_mode = 1 - kernel
    rhs = user_mode + check_under
    if diff == 0:
        if rhs != 0:
            raise ValueError("stack length at a disallowed value")
        trace[STACK_LEN_BOUNDS_AUX, j] = 0
    else:
        trace[STACK_LEN_BOUNDS_AUX, j] = _inverse(diff) * rhs % gl.P


def wire_stack_op(trace: np.ndarray, j: int, opcode: int,
                  stack: list, push_value=None, context: int = 0) -> None:
    """Wire the stack channels of an op row per its stack behavior:
    `stack` is the pre-instruction stack, bottom first.  Pop channels read
    the top slots; the push channel (if any) writes the net-new top."""
    behavior = CpuStark._STACK_BEHAVIORS.get(_op_name(opcode))
    trace[STACK_LEN, j] = len(stack)
    set_stack_bounds_aux(trace, j)
    if behavior is None:
        return
    num_pops, pushes, _ = behavior
    stack_seg = int(Segment.Stack)
    for i in range(num_pops):
        trace[_CHANNEL_COLS[i], j] = [1, 1, context, stack_seg,
                                      len(stack) - 1 - i,
                                      *u256_limbs(stack[-1 - i])]
    if pushes:
        cols = _CHANNEL_COLS[NUM_GP_CHANNELS - 1]
        head = [1, 0, context, stack_seg, len(stack) - num_pops]
        if push_value is None:
            trace[cols[:5], j] = head
        else:
            trace[cols, j] = head + u256_limbs(push_value)


def u256_limbs(value: int) -> list:
    """The eight 32-bit limbs of a 256-bit value, least significant
    first."""
    return [(value >> (32 * i)) & 0xFFFFFFFF for i in range(VALUE_LIMBS)]


def set_u256_channel(trace: np.ndarray, j: int, channel: int, value: int):
    trace[MEM_CHANNELS[channel].value, j] = u256_limbs(value)


def set_eq_iszero_values(trace: np.ndarray, j: int, val0: int, val1: int):
    """Witness EQ/ISZERO: inputs in channels 0/1, result bit in channel 2,
    pseudoinverse certificate in the GENERAL columns
    (reference eq_iszero.rs:22-49 generate_pinv_diff)."""
    from ..field import goldilocks as gl
    set_u256_channel(trace, j, 0, val0)
    set_u256_channel(trace, j, 1, val1)
    l0 = [(val0 >> (32 * i)) & 0xFFFFFFFF for i in range(VALUE_LIMBS)]
    l1 = [(val1 >> (32 * i)) & 0xFFFFFFFF for i in range(VALUE_LIMBS)]
    num_unequal = sum(a != b for a, b in zip(l0, l1))
    set_u256_channel(trace, j, NUM_GP_CHANNELS - 1, int(num_unequal == 0))
    n_inv = pow(num_unequal, gl.P - 2, gl.P) if num_unequal else 0
    for c, a, b in zip(GENERAL, l0, l1):
        d = (a - b) % gl.P
        d_inv = pow(d, gl.P - 2, gl.P) if d else 0
        trace[c, j] = d_inv * n_inv % gl.P


def fill_jump_row(trace: np.ndarray, j: int, opcode: int, pc: int, dst: int,
                  cond: int = 1, kernel_mode: bool = True,
                  context: int = 0) -> None:
    """Witness a JUMP (0x56) / JUMPI (0x57) row
    (reference witness/operation.rs jump handling)."""
    from ..field import goldilocks as gl
    fill_cycle_row(trace, j, opcode, kernel_mode, context, pc=pc)
    if opcode == 0x56:
        cond = 1
        wire_stack_op(trace, j, opcode, [dst], context=context)
    else:
        wire_stack_op(trace, j, opcode, [cond, dst], context=context)
    set_u256_channel(trace, j, 0, dst)
    set_u256_channel(trace, j, 1, cond)
    should = int(cond != 0)
    trace[JUMPS_SHOULD_JUMP, j] = should
    cond_sum = sum((cond >> (32 * i)) & 0xFFFFFFFF
                   for i in range(VALUE_LIMBS)) % gl.P
    trace[JUMPS_COND_SUM_PINV, j] = \
        pow(cond_sum, gl.P - 2, gl.P) if cond_sum else 0
    ch = MEM_CHANNELS[NUM_GP_CHANNELS - 1]
    trace[ch.value[0], j] = 1
    trace[ch.used, j] = should * (1 - int(kernel_mode))
    trace[ch.is_read, j] = 1
    trace[ch.addr_context, j] = context
    trace[ch.addr_segment, j] = int(Segment.JumpdestBits)
    trace[ch.addr_virtual, j] = dst
    if j + 1 < trace.shape[1]:
        trace[PROGRAM_COUNTER, j + 1] = dst if should else pc + 1


def generate_bootstrap_kernel(kernel: Kernel, min_rows: int = 8
                              ) -> Tuple[np.ndarray, List[MemoryOp],
                                         List[KeccakSpongeOp]]:
    """CPU trace + the memory writes + the sponge op of the bootstrap phase
    (reference bootstrap_kernel.rs:23-57)."""
    code = kernel.code
    chunks = [code[i:i + NUM_GP_CHANNELS]
              for i in range(0, len(code), NUM_GP_CHANNELS)]
    n = len(chunks) + 1
    rows = max(n, min_rows)
    rows = 1 << (rows - 1).bit_length()
    if rows == n:  # the last row must not be a bootstrap row
        rows *= 2
    trace = np.zeros((NUM_CPU_COLUMNS, rows), dtype=np.uint64)
    trace[CLOCK] = np.arange(rows, dtype=np.uint64)
    memory_ops: List[MemoryOp] = []

    for clock, chunk in enumerate(chunks):
        trace[IS_BOOTSTRAP_KERNEL, clock] = 1
        for i, byte in enumerate(chunk):
            ch = MEM_CHANNELS[i]
            addr = clock * NUM_GP_CHANNELS + i
            trace[ch.used, clock] = 1
            trace[ch.is_read, clock] = 0
            trace[ch.addr_context, clock] = 0
            trace[ch.addr_segment, clock] = int(Segment.Code)
            trace[ch.addr_virtual, clock] = addr
            trace[ch.value[0], clock] = byte
            memory_ops.append(MemoryOp(
                filter=True, is_read=False, context=0,
                segment=int(Segment.Code), virt=addr, value=byte,
                timestamp=clock * NUM_CHANNELS
                + MEM_GP_CHANNELS_IDX_START + i))

    final = len(chunks)
    trace[IS_BOOTSTRAP_KERNEL, final] = 1
    trace[IS_KECCAK_SPONGE, final] = 1
    trace[MEM_CHANNELS[0].value[0], final] = 0                  # context
    trace[MEM_CHANNELS[1].value[0], final] = int(Segment.Code)  # segment
    trace[MEM_CHANNELS[2].value[0], final] = 0                  # virt
    trace[MEM_CHANNELS[3].value[0], final] = len(code)          # len
    for i, limb in enumerate(kernel.code_hash):
        trace[MEM_CHANNELS[4].value[i], final] = limb

    sponge_op = KeccakSpongeOp(context=0, segment=int(Segment.Code), virt=0,
                               timestamp=final * NUM_CHANNELS, input=code)
    return trace, memory_ops, [sponge_op]


# --- the STARK ------------------------------------------------------------

class CpuStark(Stark):
    COLUMNS = NUM_CPU_COLUMNS
    PUBLIC_INPUTS = 0

    def __init__(self, kernel: Kernel):
        self.kernel = kernel

    def eval(self, alg, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = alg.one()

        # bootstrap flag: starts at 1, ends at 0, delta in {0, -1}
        # (reference bootstrap_kernel.rs:59-76)
        is_bootstrap = lv[IS_BOOTSTRAP_KERNEL]
        nxt_bootstrap = nv[IS_BOOTSTRAP_KERNEL]
        yield_constr.constraint_first_row(alg.sub(is_bootstrap, one))
        yield_constr.constraint_last_row(is_bootstrap)
        delta = alg.sub(nxt_bootstrap, is_bootstrap)
        yield_constr.constraint_transition(
            alg.mul(delta, alg.add(delta, one)))

        # bootstrap memory channels write the code segment sequentially
        # (reference bootstrap_kernel.rs:77-89)
        for i, ch in enumerate(MEM_CHANNELS):
            filt = alg.mul(is_bootstrap, lv[ch.used])
            yield_constr.constraint(alg.mul(filt, lv[ch.addr_context]))
            yield_constr.constraint(alg.mul(
                filt, alg.sub(lv[ch.addr_segment],
                              alg.const(int(Segment.Code)))))
            expected_virt = alg.add_const(
                alg.mul_const(lv[CLOCK], NUM_GP_CHANNELS), i)
            yield_constr.constraint(alg.mul(
                filt, alg.sub(lv[ch.addr_virtual], expected_virt)))
            # bootstrap channels are writes
            yield_constr.constraint(alg.mul(filt, lv[ch.is_read]))

        # the final bootstrap row carries the precomputed kernel code hash
        # (reference bootstrap_kernel.rs:91-100); delta = -1 there
        for i, expected in enumerate(self.kernel.code_hash):
            diff = alg.sub(alg.const(expected),
                           lv[MEM_CHANNELS[4].value[i]])
            yield_constr.constraint_transition(alg.mul(delta, diff))
        # ... and is a sponge-lookup row; the flag fires there and on
        # KECCAK_GENERAL cycle rows, which hash a memory range through the
        # same sponge CTL (the reference only ever sets it on the bootstrap
        # row because its CTLs ship disabled)
        kg = alg.mul(lv[IS_CPU_CYCLE], lv[OP["keccak_general"]])
        yield_constr.constraint_transition(
            alg.sub(lv[IS_KECCAK_SPONGE],
                    alg.add(alg.mul(delta, alg.sub(alg.zero(), one)), kg)))

        # flags are boolean; channel `used` is boolean (membus.rs:34-60)
        for c in ([IS_BOOTSTRAP_KERNEL, IS_CPU_CYCLE, IS_KECCAK_SPONGE,
                   IS_KERNEL_MODE] + list(OP.values())
                  + [ch.used for ch in MEM_CHANNELS]
                  + [ch.is_read for ch in MEM_CHANNELS]):
            yield_constr.constraint(alg.mul(lv[c], alg.sub(lv[c], one)))

        # clock starts at 0 and increments (cpu_stark.rs eval)
        yield_constr.constraint_first_row(lv[CLOCK])
        yield_constr.constraint_transition(
            alg.sub(alg.sub(nv[CLOCK], lv[CLOCK]), one))

        # code_context = (1 - is_kernel_mode) * context (membus.rs:35-48)
        filt = lv[IS_CPU_CYCLE]
        expected_ctx = alg.mul(alg.sub(one, lv[IS_KERNEL_MODE]), lv[CONTEXT])
        yield_constr.constraint(alg.mul(
            filt, alg.sub(lv[CODE_CONTEXT], expected_ctx)))

        self._eval_decode(alg, lv, yield_constr)
        self._eval_pc(alg, lv, yield_constr)
        self._eval_not(alg, lv, yield_constr)
        self._eval_eq_iszero(alg, lv, yield_constr)
        self._eval_jumps(alg, lv, nv, yield_constr)
        self._eval_contextops(alg, lv, nv, yield_constr)
        self._eval_modfp254(alg, lv, yield_constr)
        self._eval_shift(alg, lv, yield_constr)
        self._eval_dup_swap(alg, lv, yield_constr)
        self._eval_memio(alg, lv, yield_constr)
        self._eval_syscalls(alg, lv, nv, yield_constr)
        self._eval_control_flow(alg, lv, nv, yield_constr)
        self._eval_stack(alg, lv, yield_constr)
        self._eval_stack_bounds(alg, lv, yield_constr)

    def _eval_decode(self, alg, lv, yield_constr) -> None:
        """Opcode-bit decoding into instruction flags on cycle rows
        (reference decode.rs:155-210).  Deviation: a flag's opcode match
        checks the top ``8 - log2(block length)`` bits; the reference's
        ``take(block_length + 1)`` checks only the top bit for single-opcode
        blocks (decode.rs:191-196), which would let a dishonest prover raise
        e.g. the ADD flag for any 0x0*-0x7* opcode."""
        one = alg.one()
        cycle = lv[IS_CPU_CYCLE]
        kernel = lv[IS_KERNEL_MODE]

        for b in OPCODE_BITS:
            yield_constr.constraint(
                alg.mul(cycle, alg.mul(lv[b], alg.sub(lv[b], one))))

        flag_sum = alg.zero()
        for _, _, _, name in OPCODE_BLOCKS:
            flag = lv[OP[name]]
            flag_sum = alg.add(flag_sum, flag)
        yield_constr.constraint(
            alg.mul(cycle, alg.mul(flag_sum, alg.sub(flag_sum, one))))

        for start, lb, kernel_only, name in OPCODE_BLOCKS:
            unavailable = alg.sub(one, kernel) if kernel_only else alg.zero()
            mismatch = alg.zero()
            for bit_idx in range(7, lb - 1, -1):
                flag_bit = (start >> bit_idx) & 1
                row_bit = lv[OPCODE_BITS[bit_idx]]
                mismatch = alg.add(
                    mismatch, alg.sub(one, row_bit) if flag_bit else row_bit)
            yield_constr.constraint(alg.mul(
                cycle, alg.mul(lv[OP[name]],
                               alg.add(unavailable, mismatch))))

    def _eval_pc(self, alg, lv, yield_constr) -> None:
        """GETPC pushes the program counter (reference pc.rs:10-20)."""
        filt = lv[OP["pc"]]
        push_value = MEM_CHANNELS[NUM_GP_CHANNELS - 1].value
        yield_constr.constraint(alg.mul(
            filt, alg.sub(lv[push_value[0]], lv[PROGRAM_COUNTER])))
        for c in push_value[1:]:
            yield_constr.constraint(alg.mul(filt, lv[c]))

    def _eval_not(self, alg, lv, yield_constr) -> None:
        """NOT: output = 0xffffffff - input per 32-bit limb
        (reference simple_logic/not.rs:14-29)."""
        filt = alg.mul(lv[IS_CPU_CYCLE], lv[OP["not_"]])
        inp = MEM_CHANNELS[0].value
        out = MEM_CHANNELS[NUM_GP_CHANNELS - 1].value
        all1 = alg.const((1 << 32) - 1)
        for i, o in zip(inp, out):
            yield_constr.constraint(alg.mul(
                filt, alg.sub(alg.add(lv[o], lv[i]), all1)))

    def _eval_eq_iszero(self, alg, lv, yield_constr) -> None:
        """EQ/ISZERO with a pseudoinverse witness: output bit is 1 iff the
        256-bit inputs are equal (reference simple_logic/eq_iszero.rs:51-120;
        ISZERO is EQ(x, 0)).  diff_pinv lives in the shared GENERAL
        columns."""
        one = alg.one()
        input0 = [lv[c] for c in MEM_CHANNELS[0].value]
        input1 = [lv[c] for c in MEM_CHANNELS[1].value]
        # Deviation: the result goes out through the PUSH channel; the
        # reference computes it into channel 2 (eq_iszero.rs:31) which the
        # stack behaviors then disable, so the pushed value would be
        # unconstrained.
        output = [lv[c] for c in MEM_CHANNELS[NUM_GP_CHANNELS - 1].value]
        diff_pinv = [lv[c] for c in GENERAL]
        eq_f = lv[OP["eq"]]
        iszero_f = lv[OP["iszero"]]
        filt = alg.add(eq_f, iszero_f)

        equal = output[0]
        unequal = alg.sub(one, equal)
        yield_constr.constraint(alg.mul(filt, alg.mul(equal, unequal)))
        for limb in output[1:]:
            yield_constr.constraint(alg.mul(filt, limb))
        for limb in input1:
            yield_constr.constraint(alg.mul(iszero_f, limb))
        # equal == 1 forces all limbs equal
        for l0, l1 in zip(input0, input1):
            yield_constr.constraint(
                alg.mul(filt, alg.mul(equal, alg.sub(l0, l1))))
        # unequal forces a witnessed certificate: (in0-in1) . diff_pinv == 1
        dot = alg.zero()
        for l0, l1, pinv in zip(input0, input1, diff_pinv):
            dot = alg.add(dot, alg.mul(alg.sub(l0, l1), pinv))
        yield_constr.constraint(alg.mul(filt, alg.sub(dot, unequal)))

    def _eval_jumps(self, alg, lv, nv, yield_constr) -> None:
        """JUMP/JUMPI program-counter transitions with a jumpdest-bit memory
        lookup in user mode, and EXIT_KERNEL restoring (pc, kernel flag)
        (reference jumps.rs:12-28, 46-140).  JUMP is JUMPI with cond = 1."""
        one = alg.one()
        # EXIT_KERNEL
        ek = alg.mul(lv[IS_CPU_CYCLE], lv[OP["exit_kernel"]])
        inp = MEM_CHANNELS[0].value
        yield_constr.constraint_transition(alg.mul(
            ek, alg.sub(lv[inp[0]], nv[PROGRAM_COUNTER])))
        yield_constr.constraint_transition(alg.mul(
            ek, alg.sub(lv[inp[1]], nv[IS_KERNEL_MODE])))

        # JUMP / JUMPI
        dst = [lv[c] for c in MEM_CHANNELS[0].value]
        cond = [lv[c] for c in MEM_CHANNELS[1].value]
        filt = alg.add(lv[OP["jump"]], lv[OP["jumpi"]])
        should = lv[JUMPS_SHOULD_JUMP]
        pinv = lv[JUMPS_COND_SUM_PINV]
        flag_ch = MEM_CHANNELS[NUM_GP_CHANNELS - 1]

        yield_constr.constraint(
            alg.mul(lv[OP["jump"]], alg.sub(cond[0], one)))
        for limb in cond[1:]:
            yield_constr.constraint(alg.mul(lv[OP["jump"]], limb))

        yield_constr.constraint(
            alg.mul(filt, alg.mul(should, alg.sub(should, one))))
        cond_sum = alg.zero()
        for limb in cond:
            cond_sum = alg.add(cond_sum, limb)
        yield_constr.constraint(
            alg.mul(filt, alg.mul(alg.sub(should, one), cond_sum)))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(alg.mul(pinv, cond_sum), should)))

        dst_hi = alg.zero()
        for limb in dst[1:]:
            dst_hi = alg.add(dst_hi, limb)
        yield_constr.constraint(alg.mul(filt, alg.mul(should, dst_hi)))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[flag_ch.value[0]], one)))

        # jumpdest-bit read: only needed when jumping outside kernel mode
        expected_used = alg.mul(should, alg.sub(one, lv[IS_KERNEL_MODE]))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[flag_ch.used], expected_used)))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[flag_ch.is_read], one)))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[flag_ch.addr_context], lv[CONTEXT])))
        yield_constr.constraint(alg.mul(
            filt, alg.sub(lv[flag_ch.addr_segment],
                          alg.const(int(Segment.JumpdestBits)))))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[flag_ch.addr_virtual], dst[0])))

        for ch in MEM_CHANNELS[2:NUM_GP_CHANNELS - 1]:
            yield_constr.constraint(alg.mul(filt, lv[ch.used]))
        yield_constr.constraint(
            alg.mul(lv[OP["jump"]], lv[MEM_CHANNELS[1].used]))

        fallthrough = alg.add(lv[PROGRAM_COUNTER], one)
        yield_constr.constraint_transition(alg.mul(
            filt, alg.mul(alg.sub(should, one),
                          alg.sub(nv[PROGRAM_COUNTER], fallthrough))))
        yield_constr.constraint_transition(alg.mul(
            filt, alg.mul(should, alg.sub(nv[PROGRAM_COUNTER], dst[0]))))

    def _eval_contextops(self, alg, lv, nv, yield_constr) -> None:
        """GET_CONTEXT pushes the context; SET_CONTEXT pops the next one
        (reference contextops.rs:10-45)."""
        get_f = lv[OP["get_context"]]
        push = MEM_CHANNELS[NUM_GP_CHANNELS - 1].value
        yield_constr.constraint(
            alg.mul(get_f, alg.sub(lv[push[0]], lv[CONTEXT])))
        for c in push[1:]:
            yield_constr.constraint(alg.mul(get_f, lv[c]))
        set_f = lv[OP["set_context"]]
        yield_constr.constraint_transition(alg.mul(
            set_f, alg.sub(lv[MEM_CHANNELS[0].value[0]], nv[CONTEXT])))

    # bn254 base-field prime as 32-bit limbs (reference modfp254.rs:13-16)
    _P254_LIMBS = [0xD87CFD47, 0x3C208C16, 0x6871CA8D, 0x97816A91,
                   0x8181585D, 0xB85045B6, 0xE131A029, 0x30644E72]

    def _eval_modfp254(self, alg, lv, yield_constr) -> None:
        """ADDFP254/MULFP254/SUBFP254 pin the modulus channel to the bn254
        prime so the generalized modular path applies
        (reference modfp254.rs:18-32)."""
        ops = alg.add(alg.add(lv[OP["addfp254"]], lv[OP["mulfp254"]]),
                      lv[OP["subfp254"]])
        filt = alg.mul(lv[IS_CPU_CYCLE], ops)
        for c, p_limb in zip(MEM_CHANNELS[2].value, self._P254_LIMBS):
            yield_constr.constraint(
                alg.mul(filt, alg.sub(lv[c], alg.const(p_limb))))

    def _eval_shift(self, alg, lv, yield_constr) -> None:
        """SHL/SHR read 2^displacement from the kernel shift table when the
        displacement fits 32 bits (reference shift.rs:11-60); the product /
        quotient itself is a cross-table obligation on the arithmetic
        table."""
        one = alg.one()
        is_shift = alg.add(lv[OP["shl"]], lv[OP["shr"]])
        disp = MEM_CHANNELS[0]
        two_exp = MEM_CHANNELS[2]
        hi_zero = lv[two_exp.used]
        yield_constr.constraint(
            alg.mul(is_shift, alg.sub(lv[two_exp.is_read], one)))
        hi_sum = alg.zero()
        for c in disp.value[1:]:
            hi_sum = alg.add(hi_sum, lv[c])
        hi_sum_inv = lv[GENERAL[0]]  # shift view of the general union
        t = alg.sub(alg.mul(hi_sum, hi_sum_inv), alg.sub(one, hi_zero))
        yield_constr.constraint(alg.mul(is_shift, t))
        yield_constr.constraint(
            alg.mul(is_shift, alg.mul(hi_sum, hi_zero)))
        yield_constr.constraint(alg.mul(is_shift, lv[two_exp.addr_context]))
        yield_constr.constraint(alg.mul(
            is_shift, alg.sub(lv[two_exp.addr_segment],
                              alg.const(int(Segment.ShiftTable)))))
        yield_constr.constraint(alg.mul(
            is_shift, alg.sub(lv[two_exp.addr_virtual], lv[disp.value[0]])))
        for ch in MEM_CHANNELS[3:NUM_GP_CHANNELS - 1]:
            yield_constr.constraint(alg.mul(is_shift, lv[ch.used]))

    def _constrain_stack_channel(self, alg, lv, yield_constr, filt, channel,
                                 is_read: bool, offset) -> None:
        """Channel reads/writes the stack at depth `offset` from the top
        (reference dup_swap.rs:36-57)."""
        one = alg.one()
        yield_constr.constraint(alg.mul(filt, alg.sub(lv[channel.used], one)))
        want_read = one if is_read else alg.zero()
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[channel.is_read], want_read)))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[channel.addr_context], lv[CONTEXT])))
        yield_constr.constraint(alg.mul(
            filt, alg.sub(lv[channel.addr_segment],
                          alg.const(int(Segment.Stack)))))
        addr = alg.sub(alg.sub(lv[STACK_LEN], one), offset)
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[channel.addr_virtual], addr)))

    def _eval_dup_swap(self, alg, lv, yield_constr) -> None:
        """DUPn copies stack[n] to a new top; SWAPn exchanges stack[0] and
        stack[n+1]; n comes from the low opcode bits
        (reference dup_swap.rs:95-215)."""
        n = alg.zero()
        for i in range(4):
            n = alg.add(n, alg.mul_const(lv[OPCODE_BITS[i]], 1 << i))

        # DUP
        filt = alg.mul(lv[IS_CPU_CYCLE], lv[OP["dup"]])
        inp = MEM_CHANNELS[0]
        out = MEM_CHANNELS[NUM_GP_CHANNELS - 1]
        for a, b in zip(inp.value, out.value):
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[a], lv[b])))
        self._constrain_stack_channel(alg, lv, yield_constr, filt, inp,
                                      True, n)
        self._constrain_stack_channel(alg, lv, yield_constr, filt, out,
                                      False, alg.const(gl.P - 1))

        # SWAP
        filt = alg.mul(lv[IS_CPU_CYCLE], lv[OP["swap"]])
        n_plus_one = alg.add(n, alg.one())
        in1, in2 = MEM_CHANNELS[0], MEM_CHANNELS[1]
        out1 = MEM_CHANNELS[NUM_GP_CHANNELS - 2]
        out2 = MEM_CHANNELS[NUM_GP_CHANNELS - 1]
        for a, b in zip(in1.value, out1.value):
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[a], lv[b])))
        for a, b in zip(in2.value, out2.value):
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[a], lv[b])))
        self._constrain_stack_channel(alg, lv, yield_constr, filt, in1,
                                      True, alg.zero())
        self._constrain_stack_channel(alg, lv, yield_constr, filt, in2,
                                      True, n_plus_one)
        self._constrain_stack_channel(alg, lv, yield_constr, filt, out1,
                                      False, n_plus_one)
        self._constrain_stack_channel(alg, lv, yield_constr, filt, out2,
                                      False, alg.zero())

    def _eval_memio(self, alg, lv, yield_constr) -> None:
        """MLOAD_GENERAL/MSTORE_GENERAL: the address triple comes from the
        first three channels; the load/store channel reads or writes it
        (reference memio.rs:10-115)."""
        one = alg.one()
        addr = [lv[MEM_CHANNELS[i].value[0]] for i in range(3)]

        filt = lv[OP["mload_general"]]
        load = MEM_CHANNELS[3]
        push = MEM_CHANNELS[NUM_GP_CHANNELS - 1]
        yield_constr.constraint(alg.mul(filt, alg.sub(lv[load.used], one)))
        yield_constr.constraint(alg.mul(filt, alg.sub(lv[load.is_read], one)))
        for c, a in zip((load.addr_context, load.addr_segment,
                         load.addr_virtual), addr):
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[c], a)))
        for lc, pc in zip(load.value, push.value):
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[lc], lv[pc])))

        filt = lv[OP["mstore_general"]]
        value = MEM_CHANNELS[3]
        store = MEM_CHANNELS[4]
        yield_constr.constraint(alg.mul(filt, alg.sub(lv[store.used], one)))
        yield_constr.constraint(alg.mul(filt, lv[store.is_read]))
        for c, a in zip((store.addr_context, store.addr_segment,
                         store.addr_virtual), addr):
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[c], a)))
        for vc, sc in zip(value.value, store.value):
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[vc], lv[sc])))

    def _eval_syscalls(self, alg, lv, nv, yield_constr) -> None:
        """SYSCALL reads the 3-byte handler address from the kernel's
        syscall jumptable, jumps there in kernel mode, and pushes the return
        (pc+1, kernel flag) (reference syscalls.rs:21-82).  If the kernel
        defines no jumptable, the syscall flag is pinned to zero."""
        from .kernel.assembler import BYTES_PER_OFFSET
        one = alg.one()
        if "syscall_jumptable" not in self.kernel.global_labels:
            yield_constr.constraint(lv[OP["syscall"]])
            return
        filt = alg.mul(lv[IS_CPU_CYCLE], lv[OP["syscall"]])
        jumptable = self.kernel.global_labels["syscall_jumptable"]
        opcode = alg.zero()
        for i in range(8):
            opcode = alg.add(opcode, alg.mul_const(lv[OPCODE_BITS[i]], 1 << i))
        addr_start = alg.add_const(
            alg.mul_const(opcode, BYTES_PER_OFFSET), jumptable)
        for i in range(BYTES_PER_OFFSET):
            ch = MEM_CHANNELS[i]
            yield_constr.constraint(alg.mul(filt, alg.sub(lv[ch.used], one)))
            yield_constr.constraint(
                alg.mul(filt, alg.sub(lv[ch.is_read], one)))
            yield_constr.constraint(alg.mul(filt, lv[ch.addr_context]))
            yield_constr.constraint(alg.mul(
                filt, alg.sub(lv[ch.addr_segment],
                              alg.const(int(Segment.Code)))))
            yield_constr.constraint(alg.mul(
                filt, alg.sub(lv[ch.addr_virtual],
                              alg.add_const(addr_start, i))))
        for ch in MEM_CHANNELS[BYTES_PER_OFFSET:NUM_GP_CHANNELS - 1]:
            yield_constr.constraint(alg.mul(filt, lv[ch.used]))

        # handler address bytes are big-endian in code memory
        target = alg.zero()
        for i in range(BYTES_PER_OFFSET):
            target = alg.add(alg.mul_const(target, 256),
                             lv[MEM_CHANNELS[i].value[0]])
        yield_constr.constraint_transition(
            alg.mul(filt, alg.sub(nv[PROGRAM_COUNTER], target)))
        yield_constr.constraint_transition(
            alg.mul(filt, alg.sub(nv[IS_KERNEL_MODE], one)))
        yield_constr.constraint_transition(
            alg.mul(filt, alg.sub(nv[CONTEXT], lv[CONTEXT])))

        output = MEM_CHANNELS[NUM_GP_CHANNELS - 1].value
        yield_constr.constraint(alg.mul(
            filt, alg.sub(lv[output[0]],
                          alg.add(lv[PROGRAM_COUNTER], one))))
        yield_constr.constraint(
            alg.mul(filt, alg.sub(lv[output[1]], lv[IS_KERNEL_MODE])))
        for c in output[2:]:
            yield_constr.constraint(alg.mul(filt, lv[c]))

    # ops whose next pc is simply pc+1 (reference control_flow.rs:10-48)
    _NATIVE_OPS = ["add", "mul", "sub", "div", "mod_", "addmod", "mulmod",
                   "addfp254", "mulfp254", "subfp254", "lt", "gt", "eq",
                   "iszero", "and_", "or_", "xor", "not_", "shl", "shr",
                   "keccak_general", "prover_input", "pop", "pc", "gas",
                   "jumpdest", "dup", "swap", "get_context", "set_context",
                   "consume_gas", "mload_general", "mstore_general"]

    def _eval_control_flow(self, alg, lv, nv, yield_constr) -> None:
        """Native instructions advance pc by one and keep the privilege
        flag; the first cycle row starts at `main` in kernel mode with an
        empty stack (reference control_flow.rs:67-107).  The halt-loop and
        cycles-until-the-end endgame constraints activate only for kernels
        that define main/halt_pc0/halt_pc1 — i.e. once full execution
        witnesses exist; bootstrap-only proofs stay valid meanwhile."""
        one = alg.one()
        native = alg.zero()
        for name in self._NATIVE_OPS:
            native = alg.add(native, lv[OP[name]])
        cyc = lv[IS_CPU_CYCLE]
        yield_constr.constraint_transition(alg.mul(
            alg.mul(cyc, native),
            alg.sub(alg.add(lv[PROGRAM_COUNTER], one), nv[PROGRAM_COUNTER])))
        yield_constr.constraint_transition(alg.mul(
            alg.mul(cyc, native),
            alg.sub(lv[IS_KERNEL_MODE], nv[IS_KERNEL_MODE])))

        labels = self.kernel.global_labels
        if all(k in labels for k in ("main", "halt_pc0", "halt_pc1")):
            yield_constr.constraint_transition(
                alg.mul(cyc, alg.sub(nv[IS_CPU_CYCLE], one)))
            last_noncpu = alg.mul(alg.sub(cyc, one), nv[IS_CPU_CYCLE])
            yield_constr.constraint_transition(alg.mul(
                last_noncpu, alg.sub(nv[PROGRAM_COUNTER],
                                     alg.const(labels["main"]))))
            yield_constr.constraint_transition(alg.mul(
                last_noncpu, alg.sub(nv[IS_KERNEL_MODE], one)))
            yield_constr.constraint_transition(
                alg.mul(last_noncpu, nv[STACK_LEN]))
            yield_constr.constraint_last_row(alg.sub(cyc, one))
            yield_constr.constraint_last_row(alg.mul(
                alg.sub(lv[PROGRAM_COUNTER], alg.const(labels["halt_pc0"])),
                alg.sub(lv[PROGRAM_COUNTER], alg.const(labels["halt_pc1"]))))
            yield_constr.constraint_last_row(alg.sub(lv[IS_KERNEL_MODE], one))

    # (num_pops, pushes, disable_other_channels) per op; None = the op
    # constrains its channels itself (reference stack.rs:20-124)
    _STACK_BEHAVIORS = {
        "add": (2, True, True), "mul": (2, True, True),
        "sub": (2, True, True), "div": (2, True, True),
        # ADDMOD/MULMOD pop THREE operands; the reference's
        # BASIC_TERNARY_OP erroneously declares num_pops: 2
        # (stack.rs:31-35) so its stack-length transition for these ops is
        # wrong — fixed here (and exercised by executed-kernel proofs).
        "mod_": (2, True, True), "addmod": (3, True, True),
        "mulmod": (3, True, True), "addfp254": (2, True, True),
        "mulfp254": (2, True, True), "subfp254": (2, True, True),
        "lt": (2, True, True), "gt": (2, True, True),
        "eq": (2, True, True), "iszero": (1, True, True),
        "and_": (2, True, True), "or_": (2, True, True),
        "xor": (2, True, True), "not_": (1, True, True),
        "byte": (2, True, True), "shl": (2, True, False),
        "shr": (2, True, False),
        "keccak_general": (4, True, False),
        "prover_input": (0, True, True),
        "jump": (1, False, False), "jumpi": (2, False, False),
        "pc": (0, True, True), "jumpdest": (0, False, True),
        "get_context": (0, True, True), "set_context": (1, False, True),
        "exit_kernel": (1, False, True),
        "mload_general": (3, True, False),
        "mstore_general": (4, False, False),
        "syscall": (0, True, False),
        # the reference leaves both unwired (stack.rs:101 `consume_gas:
        # None // TODO`, no `gas` entry): GAS pushes the remaining gas,
        # CONSUME_GAS pops the amount to charge
        "gas": (0, True, True),
        "consume_gas": (1, False, True),
    }
    MAX_USER_STACK_SIZE = 1024

    def _eval_stack(self, alg, lv, yield_constr) -> None:
        """Each op's pops read stack[len-1-i] through the first channels and
        a push writes stack[len-num_pops] through the last
        (reference stack.rs:126-183)."""
        one = alg.one()
        for name, (num_pops, pushes, disable) in self._STACK_BEHAVIORS.items():
            filt = alg.mul(lv[IS_CPU_CYCLE], lv[OP[name]])
            for i in range(num_pops):
                ch = MEM_CHANNELS[i]
                yield_constr.constraint(
                    alg.mul(filt, alg.sub(lv[ch.used], one)))
                yield_constr.constraint(
                    alg.mul(filt, alg.sub(lv[ch.is_read], one)))
                yield_constr.constraint(
                    alg.mul(filt, alg.sub(lv[ch.addr_context], lv[CONTEXT])))
                yield_constr.constraint(alg.mul(
                    filt, alg.sub(lv[ch.addr_segment],
                                  alg.const(int(Segment.Stack)))))
                addr = alg.add_const(lv[STACK_LEN], gl.P - (i + 1))
                yield_constr.constraint(
                    alg.mul(filt, alg.sub(lv[ch.addr_virtual], addr)))
            if pushes:
                ch = MEM_CHANNELS[NUM_GP_CHANNELS - 1]
                yield_constr.constraint(
                    alg.mul(filt, alg.sub(lv[ch.used], one)))
                yield_constr.constraint(alg.mul(filt, lv[ch.is_read]))
                yield_constr.constraint(
                    alg.mul(filt, alg.sub(lv[ch.addr_context], lv[CONTEXT])))
                yield_constr.constraint(alg.mul(
                    filt, alg.sub(lv[ch.addr_segment],
                                  alg.const(int(Segment.Stack)))))
                addr = (alg.add_const(lv[STACK_LEN], gl.P - num_pops)
                        if num_pops else lv[STACK_LEN])
                yield_constr.constraint(
                    alg.mul(filt, alg.sub(lv[ch.addr_virtual], addr)))
            if disable:
                hi = NUM_GP_CHANNELS - (1 if pushes else 0)
                for ch in MEM_CHANNELS[num_pops:hi]:
                    yield_constr.constraint(alg.mul(filt, lv[ch.used]))

    def _eval_stack_bounds(self, alg, lv, yield_constr) -> None:
        """Pop-without-read must show stack_len != 0; user-mode pushes must
        show stack_len != MAX_USER_STACK_SIZE, via the witnessed
        stack_len_bounds_aux pseudoinverse (reference stack_bounds.rs:29-102)."""
        one = alg.one()
        check_under = lv[OP["pop"]]
        check_over = alg.add(lv[OP["pc"]], lv[OP["dup"]])
        no_check = alg.sub(one, alg.add(check_under, check_over))
        disallowed = alg.sub(
            alg.mul_const(check_over, self.MAX_USER_STACK_SIZE), no_check)
        lhs = alg.mul(alg.sub(lv[STACK_LEN], disallowed),
                      lv[STACK_LEN_BOUNDS_AUX])
        user_mode = alg.sub(one, lv[IS_KERNEL_MODE])
        rhs = alg.add(user_mode, check_under)
        yield_constr.constraint(
            alg.mul(lv[IS_CPU_CYCLE], alg.sub(lhs, rhs)))

    def constraint_degree(self) -> int:
        return 3
