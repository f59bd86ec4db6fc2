"""Compiled constraint programs: data, host scalar bank, plain interpreter.

The port's counterpart of the execution half of
plonky2_tpu/plonk/constraint_program.py: the ``ConstraintProgram`` register
machine (:305), its host ``scalar_bank`` (:323) and the interpreter that
``run_numpy`` (:348) and the Pallas kernel (:459) implement.  The compiler
(tracing, CSE, wave scheduling, register allocation) stays in the JAX
package: a compiled program is plain arrays, carried across by
``program_from_arrays`` and shipped as an ``.npz`` (``save``/``load``).

Registers [0, n_inputs) are preloaded with the vector inputs.  Waves run in
order; every slot of a wave reads its operands before any slot writes (the
allocator reuses a register that dies in a wave for that wave's results),
and padded slots all write the dump register n_regs - 1, where the last
write wins.  Operand ``b`` is a bank slot for the scalar opcodes (ADDS,
SUBS, MULS, MULADDS) and a register otherwise.

``linearize`` turns the wave program into the straight op stream that
kernel K6 (plonk/constraint_program_cuda.py) runs: the real ops in an order
that keeps few values live, each value in one of a few slots, inputs read
at their use.  ``run_plain_linear`` is the plain PyTorch version of that
kernel; ``run_plain`` runs the wave program itself, and the two agree.
"""
from __future__ import annotations

import functools
import heapq
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..field import gf
from ..field import goldilocks as gl

# vector-op ISA (the JAX package's opcode numbers)
ADD = 0       # r[d] = r[a] + r[b]
SUB = 1       # r[d] = r[a] - r[b]
MUL = 2       # r[d] = r[a] * r[b]
ADDS = 3      # r[d] = r[a] + s[b]
SUBS = 4      # r[d] = s[b] - r[a]
MULS = 5      # r[d] = r[a] * s[b]
MULADD = 6    # r[d] = r[a] * r[b] + r[c]
MULADDS = 7   # r[d] = r[a] * s[b] + r[c]

N_OPCODES = 8
OP_NAMES = ["add", "sub", "mul", "adds", "subs", "muls", "muladd", "muladds"]
SCALAR_B = (ADDS, SUBS, MULS, MULADDS)
MUL_OPS = (MUL, MULS, MULADD, MULADDS)

# scalar tape node kinds: ('k', value), ('in', slot), (op, a_sid, b_sid)
TAPE_KINDS = ["k", "in", "add", "sub", "mul"]

_PROGRAM_ARRAYS = ("wave_opcodes", "wave_dst", "wave_a", "wave_b", "wave_c",
                   "out_regs", "tape_kind", "tape_a", "tape_b", "tape_const",
                   "bank_sids")
_PROGRAM_INTS = ("n_inputs", "n_regs", "wave_width", "n_scalar_inputs",
                 "n_ops")


@dataclass(eq=False)
class ConstraintProgram:
    n_inputs: int                 # vector inputs occupy regs [0, n_inputs)
    n_regs: int                   # register file height (incl. dump reg)
    wave_width: int
    wave_opcodes: np.ndarray      # (n_waves,) int32
    wave_dst: np.ndarray          # (n_waves, W) int32
    wave_a: np.ndarray            # (n_waves, W) int32
    wave_b: np.ndarray            # (n_waves, W) int32 (reg or bank slot)
    wave_c: np.ndarray            # (n_waves, W) int32
    out_regs: np.ndarray          # (n_outputs,) int32
    tape_kind: np.ndarray         # (n_nodes,) int8, index into TAPE_KINDS
    tape_a: np.ndarray            # (n_nodes,) int32: input slot or node id
    tape_b: np.ndarray            # (n_nodes,) int32: node id
    tape_const: np.ndarray        # (n_nodes,) uint64: value of a 'k' node
    bank_sids: np.ndarray         # (bank_size,) int32: slot -> node id
    n_scalar_inputs: int
    n_ops: int

    @property
    def n_waves(self) -> int:
        return int(self.wave_opcodes.shape[0])

    @property
    def n_outputs(self) -> int:
        return int(self.out_regs.shape[0])

    @property
    def dump_reg(self) -> int:
        return self.n_regs - 1

    def real_op_counts(self) -> dict:
        """opcode name -> number of real (not padded) slots."""
        real = self.wave_dst != self.dump_reg
        return {OP_NAMES[c]: int(real[self.wave_opcodes == c].sum())
                for c in range(N_OPCODES)}

    def n_mul_ops(self) -> int:
        """Real slots that do one 64x64 field product."""
        counts = self.real_op_counts()
        return sum(counts[OP_NAMES[c]] for c in MUL_OPS)

    def arrays(self) -> dict:
        out = {k: getattr(self, k) for k in _PROGRAM_ARRAYS}
        out.update({k: np.int64(getattr(self, k)) for k in _PROGRAM_INTS})
        return out

    # -- host scalar bank --------------------------------------------------

    def scalar_bank(self, scalar_inputs: List[int]) -> np.ndarray:
        """Evaluate the scalar tape in exact integers; (bank_size,) uint64
        (one zero slot when the program reads no scalar)."""
        if len(scalar_inputs) != self.n_scalar_inputs:
            raise ValueError(f"{len(scalar_inputs)} scalar inputs, expected "
                             f"{self.n_scalar_inputs}")
        P = gl.P
        vals: List[int] = []
        for kind, a, b, k in zip(self.tape_kind.tolist(), self.tape_a.tolist(),
                                 self.tape_b.tolist(),
                                 self.tape_const.tolist()):
            op = TAPE_KINDS[kind]
            if op == "k":
                vals.append(k)
            elif op == "in":
                vals.append(int(scalar_inputs[a]) % P)
            elif op == "add":
                vals.append((vals[a] + vals[b]) % P)
            elif op == "sub":
                vals.append((vals[a] - vals[b]) % P)
            else:
                vals.append((vals[a] * vals[b]) % P)
        bank = [vals[sid] for sid in self.bank_sids.tolist()] or [0]
        return np.array(bank, dtype=np.uint64)

    # -- plain interpreter (the plain version of kernel K6) ----------------

    def run_plain(self, inputs: torch.Tensor,
                  bank: torch.Tensor) -> torch.Tensor:
        """inputs (n_inputs, C) and bank (bank_size,) int64 tensors ->
        (n_outputs, C), with gf's add/sub/mul."""
        if inputs.shape[0] != self.n_inputs:
            raise ValueError(f"inputs: {inputs.shape[0]} rows, expected "
                             f"{self.n_inputs}")
        dev = inputs.device
        C = inputs.shape[-1]
        regs = inputs.new_zeros((self.n_regs, C))
        regs[:self.n_inputs] = inputs
        bank = bank.to(dev)
        for code, a, b, c, d, dump in _plain_waves(self, str(dev)):
            ra = regs[a]
            rb = bank[b][:, None] if code in SCALAR_B else regs[b]
            if code in (ADD, ADDS):
                out = gf.add(ra, rb)
            elif code == SUB:
                out = gf.sub(ra, rb)
            elif code == SUBS:
                out = gf.sub(rb, ra)
            elif code in (MUL, MULS):
                out = gf.mul(ra, rb)
            else:                                  # MULADD, MULADDS
                out = gf.add(gf.mul(ra, rb), regs[c])
            # real slots write distinct registers; of the padded slots,
            # which all write the dump register, the last one wins
            regs[d] = out[:d.shape[0]]
            if dump is not None:
                regs[self.dump_reg] = out[dump]
        return regs[torch.from_numpy(self.out_regs.astype(np.int64)).to(dev)]


@functools.lru_cache(maxsize=8)
def _plain_waves(prog: ConstraintProgram, device: str):
    """Per wave: (opcode, a, b, c, real dst, index of the last padded
    slot or None), index tensors on `device`.  Real slots come first."""
    dump = prog.dump_reg
    out = []
    for w in range(prog.n_waves):
        dst = prog.wave_dst[w]
        real = np.flatnonzero(dst != dump)
        pads = np.flatnonzero(dst == dump)
        if pads.size and real.size and real.max() > pads.min():
            raise ValueError(f"wave {w}: padded slot before a real one")
        t = [torch.from_numpy(x.astype(np.int64)).to(device)
             for x in (prog.wave_a[w], prog.wave_b[w], prog.wave_c[w],
                       dst[real])]
        out.append((int(prog.wave_opcodes[w]), *t,
                    int(pads[-1]) if pads.size else None))
    return tuple(out)


# -- the linear form that kernel K6 runs ------------------------------------

# A linear op is one uint64: opcode (4 bits) | dst slot (12) | a (16) | b (16)
# | c (16), low bits first.  An operand is a slot, or with OPERAND_INPUT set
# a row of the compact input matrix (``LinearProgram.input_rows``); with
# OPERAND_KEEP also set, the value read is also stored into slot
# ``input_slot[row]`` for later ops (an input's first use).  Operand b of
# the scalar opcodes is a bank slot; c is read only by MULADD and MULADDS.
OPERAND_INPUT = 0x8000
OPERAND_KEEP = 0x4000
OPERAND_INDEX = 0x3FFF
MAX_SLOTS = 1 << 12


@dataclass(eq=False)
class LinearProgram:
    ops: np.ndarray            # (n_ops,) uint64, packed as above
    n_slots: int               # slots a lane needs (the most values live)
    input_rows: np.ndarray     # (n_read,) int32: program input of each row
    input_slot: np.ndarray     # (n_read,) int32: slot of a kept row, else -1
    out_operands: np.ndarray   # (n_outputs,) int32: operand of each output
    n_inputs: int              # the wave program's input count

    @property
    def n_ops(self) -> int:
        return int(self.ops.shape[0])

    @property
    def n_read(self) -> int:
        return int(self.input_rows.shape[0])

    def fields(self) -> dict:
        """The packed ops' fields as int64 arrays: opcode, dst, a, b, c."""
        o = self.ops.astype(np.uint64)
        f = lambda sh, bits: ((o >> np.uint64(sh))  # noqa: E731
                              & np.uint64((1 << bits) - 1)).astype(np.int64)
        return {"opcode": f(0, 4), "dst": f(4, 12), "a": f(16, 16),
                "b": f(32, 16), "c": f(48, 16)}

    def compact_inputs(self, inputs: torch.Tensor) -> torch.Tensor:
        """(n_read, C) rows the program reads, from (n_inputs, C) inputs, or
        the inputs themselves when they already are those rows."""
        if inputs.shape[0] == self.n_read:
            return inputs
        if inputs.shape[0] != self.n_inputs:
            raise ValueError(f"inputs: {inputs.shape[0]} rows, expected "
                             f"{self.n_inputs} or {self.n_read}")
        rows = torch.from_numpy(self.input_rows.astype(np.int64))
        return inputs.index_select(0, rows.to(inputs.device))


def _ssa(prog: ConstraintProgram):
    """The wave program's real ops as SSA: values 0..n_inputs-1 are the
    inputs, value n_inputs + k is op k's result.  Returns (ops, outputs),
    ops a list of (opcode, a, b, c) with a and c value ids (c = -1 unless
    MULADD/MULADDS) and b a value id or, for the scalar opcodes, a bank
    slot."""
    cur = {r: r for r in range(prog.n_inputs)}
    dump = prog.dump_reg
    ops = []

    def read(r, w):
        if r not in cur:
            raise ValueError(f"wave {w} reads register {r} before any write")
        return cur[r]

    for w in range(prog.n_waves):
        code = int(prog.wave_opcodes[w])
        real = [k for k in range(prog.wave_width)
                if prog.wave_dst[w, k] != dump]
        new = []
        for k in real:
            a = read(int(prog.wave_a[w, k]), w)
            b = (int(prog.wave_b[w, k]) if code in SCALAR_B
                 else read(int(prog.wave_b[w, k]), w))
            c = (read(int(prog.wave_c[w, k]), w)
                 if code in (MULADD, MULADDS) else -1)
            new.append((int(prog.wave_dst[w, k]), (code, a, b, c)))
        for d, op in new:               # every read of a wave comes first
            cur[d] = prog.n_inputs + len(ops)
            ops.append(op)
    outs = [read(int(r), prog.n_waves) for r in prog.out_regs]
    return ops, outs


def _vector_operands(op) -> tuple:
    code, a, b, c = op
    vals = [a]
    if code not in SCALAR_B:
        vals.append(b)
    if c >= 0:
        vals.append(c)
    return tuple(dict.fromkeys(vals))          # distinct, in operand order


@functools.lru_cache(maxsize=16)
def linearize(prog: ConstraintProgram) -> LinearProgram:
    """The wave program as a straight stream of its real ops, for kernel K6.

    Ops no output depends on are dropped, and so are the padded slots.  The
    rest run in a greedy list schedule: of the ops whose operands are
    computed, the one that leaves the fewest values live (it frees the
    operands it reads last; an input it reads first takes a slot only if a
    later op reads it too), the latest in wave order on a tie (which
    finishes one chain of work before it starts the next).  Values then
    take the lowest free slot; an output's value stays in its slot to the
    end.  Field arithmetic is exact, so any order gives the same outputs.
    Deterministic; cached per program."""
    ops, outs = _ssa(prog)
    n_in = prog.n_inputs
    # dead-op elimination, backwards from the outputs
    live = np.zeros(len(ops), dtype=bool)
    stack = [v - n_in for v in outs if v >= n_in]
    while stack:
        k = stack.pop()
        if live[k]:
            continue
        live[k] = True
        stack.extend(v - n_in for v in _vector_operands(ops[k])
                     if v >= n_in and not live[v - n_in])
    order_in = np.flatnonzero(live).tolist()
    operands = {k: _vector_operands(ops[k]) for k in order_in}
    remaining = {}        # value -> ops (and outputs) still to read it
    for k in order_in:
        for v in operands[k]:
            remaining[v] = remaining.get(v, 0) + 1
    for v in outs:
        remaining[v] = remaining.get(v, 0) + 1
    readers = {}
    pending = {}
    for k in order_in:
        deps = [v for v in operands[k] if v >= n_in]
        pending[k] = len(deps)
        for v in deps:
            readers.setdefault(v, []).append(k)

    in_slot = set()

    def delta(k):
        d = 1
        for v in operands[k]:
            if v in in_slot:
                d -= remaining[v] == 1
            elif remaining[v] > 1:           # an input read first, kept
                d += 1
        return d

    ready = {k for k in order_in if pending[k] == 0}
    schedule = []
    while ready:
        k = min(ready, key=lambda j: (delta(j), -j))
        ready.remove(k)
        schedule.append(k)
        for v in operands[k]:
            remaining[v] -= 1
            if remaining[v] and v < n_in:
                in_slot.add(v)
            elif not remaining[v]:
                in_slot.discard(v)
        in_slot.add(n_in + k)
        for j in readers.get(n_in + k, ()):
            pending[j] -= 1
            if pending[j] == 0:
                ready.add(j)

    # slots, in schedule order
    uses = {}
    for k in schedule:
        for v in operands[k]:
            uses[v] = uses.get(v, 0) + 1
    for v in outs:
        uses[v] = uses.get(v, 0) + 1
    read_inputs = sorted({v for k in schedule for v in operands[k]
                          if v < n_in} | {v for v in outs if v < n_in})
    row_of = {v: i for i, v in enumerate(read_inputs)}
    input_slot = np.full(len(read_inputs), -1, dtype=np.int32)
    free, n_slots, slot_of = [], 0, {}

    def take():
        nonlocal n_slots
        if free:
            return heapq.heappop(free)
        n_slots += 1
        return n_slots - 1

    packed = []
    for k in schedule:
        code, a, b, c = ops[k]
        enc = {}
        for v in operands[k]:                # keeps first: they stay live
            if v in slot_of:
                enc[v] = slot_of[v]
            elif uses[v] > 1:
                slot_of[v] = input_slot[row_of[v]] = take()
                enc[v] = OPERAND_INPUT | OPERAND_KEEP | row_of[v]
            else:
                enc[v] = OPERAND_INPUT | row_of[v]
        for v in operands[k]:
            uses[v] -= 1
            if not uses[v] and v in slot_of:
                heapq.heappush(free, slot_of.pop(v))
        slot_of[n_in + k] = dst = take()
        fb = b if code in SCALAR_B else enc[b]
        if code in SCALAR_B and b > OPERAND_INDEX:
            raise ValueError(f"bank slot {b} does not fit an operand")
        packed.append(code | dst << 4 | enc[a] << 16 | fb << 32
                      | (enc[c] if c >= 0 else 0) << 48)
    if n_slots > MAX_SLOTS or len(read_inputs) > OPERAND_INDEX + 1:
        raise ValueError(f"{n_slots} slots and {len(read_inputs)} input "
                         "rows do not fit the op format")
    out_ops = [slot_of[v] if v in slot_of else OPERAND_INPUT | row_of[v]
               for v in outs]
    return LinearProgram(
        ops=np.array(packed, dtype=np.uint64), n_slots=n_slots,
        input_rows=np.array(read_inputs, dtype=np.int32),
        input_slot=input_slot, out_operands=np.array(out_ops, np.int32),
        n_inputs=n_in)


def run_plain_linear(lin: LinearProgram, inputs: torch.Tensor,
                     bank: torch.Tensor) -> torch.Tensor:
    """The plain version of kernel K6: the linear program on C lanes.
    ``inputs`` is (n_inputs, C) or the (n_read, C) rows it reads; ``bank``
    the (bank_size,) scalar bank.  Returns (n_outputs, C)."""
    x_in = lin.compact_inputs(inputs)
    C = x_in.shape[-1]
    slots = x_in.new_zeros((lin.n_slots, C))
    bank = bank.to(x_in.device)

    def fetch(f):
        if f & OPERAND_INPUT:
            row = f & OPERAND_INDEX
            if f & OPERAND_KEEP:
                slots[int(lin.input_slot[row])] = x_in[row]
            return x_in[row]
        return slots[f]

    f = lin.fields()
    for code, dst, a, b, c in zip(*(f[k].tolist() for k in (
            "opcode", "dst", "a", "b", "c"))):
        x = fetch(a)
        y = bank[b] if code in SCALAR_B else fetch(b)
        if code in (ADD, ADDS):
            v = gf.add(x, y)
        elif code == SUB:
            v = gf.sub(x, y)
        elif code == SUBS:
            v = gf.sub(y.expand_as(x), x)
        elif code in (MUL, MULS):
            v = gf.mul(x, y)
        else:                                   # MULADD, MULADDS
            v = gf.add(gf.mul(x, y), fetch(c))
        slots[dst] = v
    if not lin.out_operands.size:
        return x_in.new_zeros((0, C))
    return torch.stack([fetch(int(o)) for o in lin.out_operands.tolist()])


# -- carrying a program across, and storing it ------------------------------

def program_from_arrays(obj) -> ConstraintProgram:
    """A port program from any object with the JAX ``ConstraintProgram``'s
    attributes (read by name; nothing of the JAX package is imported)."""
    kinds, ta, tb, tk = [], [], [], []
    for rec in obj.snodes:
        op = rec[0]
        kinds.append(TAPE_KINDS.index(op))
        if op == "k":
            ta.append(0)
            tb.append(0)
            tk.append(int(rec[1]) % gl.P)
        elif op == "in":
            ta.append(int(rec[1]))
            tb.append(0)
            tk.append(0)
        else:
            ta.append(int(rec[1]))
            tb.append(int(rec[2]))
            tk.append(0)
    i32 = lambda x: np.asarray(x, dtype=np.int32)  # noqa: E731
    return ConstraintProgram(
        n_inputs=int(obj.n_inputs), n_regs=int(obj.n_regs),
        wave_width=int(obj.wave_width),
        wave_opcodes=i32(obj.wave_opcodes), wave_dst=i32(obj.wave_dst),
        wave_a=i32(obj.wave_a), wave_b=i32(obj.wave_b),
        wave_c=i32(obj.wave_c), out_regs=i32(obj.out_regs),
        tape_kind=np.asarray(kinds, dtype=np.int8), tape_a=i32(ta),
        tape_b=i32(tb), tape_const=np.asarray(tk, dtype=np.uint64),
        bank_sids=i32(obj.bank_sids),
        n_scalar_inputs=int(obj.n_scalar_inputs), n_ops=int(obj.n_ops))


def program_from_npz(arrays) -> ConstraintProgram:
    kw = {k: np.asarray(arrays[k]) for k in _PROGRAM_ARRAYS}
    kw.update({k: int(arrays[k]) for k in _PROGRAM_INTS})
    return ConstraintProgram(**kw)


def save(path: str, program: ConstraintProgram, shape=None,
         gate_ids=None) -> None:
    """One compressed ``.npz`` holding the program and, when given, the
    circuit shape (plonk/circuit_shape.py) under ``shape_`` keys and the
    ids of the circuit's gates, in order, under ``gate_ids``."""
    arrays = program.arrays()
    if shape is not None:
        arrays.update({f"shape_{k}": v for k, v in shape.arrays().items()})
    if gate_ids is not None:
        arrays["gate_ids"] = np.array(list(gate_ids), dtype=np.str_)
    np.savez_compressed(path, **arrays)


def load(path: str):
    """(program, shape or None) from a file written by ``save``."""
    from .circuit_shape import CircuitShape
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    shape_keys = {k[len("shape_"):]: v for k, v in arrays.items()
                  if k.startswith("shape_")}
    shape: Optional[CircuitShape] = (CircuitShape.from_arrays(shape_keys)
                                     if shape_keys else None)
    return program_from_npz(arrays), shape


def load_gate_ids(path: str) -> Optional[Tuple[str, ...]]:
    """The gate ids a file written by ``save`` holds, or None."""
    with np.load(path, allow_pickle=False) as z:
        return (tuple(str(g) for g in z["gate_ids"])
                if "gate_ids" in z.files else None)


def random_program(rng: np.random.Generator, n_inputs: int = 6,
                   n_waves: int = 40, wave_width: int = 8,
                   n_regs: int = 24) -> ConstraintProgram:
    """A random valid program for checking an interpreter: every opcode,
    operands read only registers already written, and destinations are
    drawn first from the registers that later slots of the same wave
    still read, so registers are reused inside waves.  Two scalar inputs;
    the bank holds them, a constant and their product."""
    W, dump = wave_width, n_regs - 1
    defined = list(range(n_inputs))
    shape = (n_waves, W)
    dst, a, b, c = (np.zeros(shape, np.int32) for _ in range(4))
    codes = rng.integers(0, N_OPCODES, n_waves).astype(np.int32)
    for w in range(n_waves):
        k_real = int(rng.integers(1, W + 1))
        pick = lambda: int(rng.choice(defined))  # noqa: E731
        for k in range(k_real):
            a[w, k], c[w, k] = pick(), pick()
            b[w, k] = (int(rng.integers(0, 4)) if codes[w] in SCALAR_B
                       else pick())
        read_later = set()
        for k in range(k_real - 1, -1, -1):
            free = [r for r in range(dump) if r not in dst[w, :k_real]]
            reuse = [r for r in free if r in read_later]
            dst[w, k] = int(rng.choice(reuse if reuse and rng.random() < 0.7
                                       else free))
            read_later |= {int(a[w, k]), int(c[w, k])}
            if codes[w] not in SCALAR_B:
                read_later.add(int(b[w, k]))
        dst[w, k_real:] = dump
        defined = sorted(set(defined) | set(dst[w, :k_real].tolist()))
    out = rng.choice(defined, size=min(4, len(defined)), replace=False)
    k = int(rng.integers(2, gl.P, dtype=np.uint64))
    return ConstraintProgram(
        n_inputs=n_inputs, n_regs=n_regs, wave_width=W, wave_opcodes=codes,
        wave_dst=dst, wave_a=a, wave_b=b, wave_c=c,
        out_regs=out.astype(np.int32),
        tape_kind=np.array([1, 1, 0, 4], np.int8),
        tape_a=np.array([0, 1, 0, 0], np.int32),
        tape_b=np.array([0, 0, 0, 1], np.int32),
        tape_const=np.array([0, 0, k, 0], np.uint64),
        bank_sids=np.arange(4, dtype=np.int32), n_scalar_inputs=2,
        n_ops=int((dst != dump).sum()))


def in_wave_reuse(prog: ConstraintProgram) -> bool:
    """Whether some slot writes a register that a later slot of its wave
    reads."""
    for w in range(prog.n_waves):
        code = int(prog.wave_opcodes[w])
        for k in range(prog.wave_width):
            d = prog.wave_dst[w, k]
            later = [prog.wave_a[w, k + 1:]]
            if code not in SCALAR_B:
                later.append(prog.wave_b[w, k + 1:])
            if code in (MULADD, MULADDS):
                later.append(prog.wave_c[w, k + 1:])
            if d != prog.dump_reg and np.isin(d, np.concatenate(later)):
                return True
    return False
