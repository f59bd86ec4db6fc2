"""Constraint programs: the compiler, the program, its plain interpreter.

The port's copy of plonky2_tpu/plonk/constraint_program.py.  The compiler
traces expressions into a hash-consed graph (``ProgramBuilder``, through
``ExprAlgebra``: common subexpressions shared, scalar-only subexpressions
folded into a host scalar tape, constants folded), then drops dead nodes,
fuses single-use products into their sums, schedules the ops into
same-opcode waves and allocates registers (``compile``).  Its output
equals the JAX compiler's array for array: every tie of the schedule and
the allocator breaks the same way.  A compiled program is plain arrays
(``ConstraintProgram``), which ``save``/``load`` keep as an ``.npz`` and
``program_from_arrays`` reads from any object with the JAX program's
attributes.  ``scalar_bank`` evaluates the scalar tape on the host;
``run_plain`` is the interpreter that ``run_numpy`` and the Pallas kernel
(JAX :459) implement.

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
from typing import Dict, List, Optional, Tuple

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



# -- the compiler (JAX :47-247, :249-302, :569-666) -------------------------

class EV:
    """Expression value handle: ('v', id) a vector node, ('s', id) a
    scalar node."""
    __slots__ = ("kind", "id")

    def __init__(self, kind: str, id_: int):
        self.kind = kind
        self.id = id_


class ProgramBuilder:
    """Hash-consed expression graph over vector inputs and host scalars."""

    def __init__(self):
        # scalar nodes: ('k', value) | ('in', slot) | (op, a_sid, b_sid)
        self.snodes: List[tuple] = []
        self._scse: Dict[tuple, int] = {}
        self.n_scalar_inputs = 0
        # vector nodes: ('in', index, None) or (opcode, x, y), x a vector
        # id and y a vector id (ADD, SUB, MUL) or a scalar id (ADDS, SUBS,
        # MULS)
        self.vnodes: List[tuple] = []
        self._vcse: Dict[tuple, int] = {}
        self.n_vector_inputs = 0
        self.outputs: List[EV] = []

    # -- the scalar graph ----------------------------------------------------

    def _snode(self, rec: tuple) -> int:
        sid = self._scse.get(rec)
        if sid is None:
            sid = len(self.snodes)
            self.snodes.append(rec)
            self._scse[rec] = sid
        return sid

    def sc_known(self, value: int) -> EV:
        return EV("s", self._snode(("k", value % gl.P)))

    def scalar_input(self) -> EV:
        slot = self.n_scalar_inputs
        self.n_scalar_inputs += 1
        return EV("s", self._snode(("in", slot)))

    def _sval(self, sid: int) -> Optional[int]:
        rec = self.snodes[sid]
        return rec[1] if rec[0] == "k" else None

    def _sop(self, op: str, a: int, b: int) -> int:
        va, vb = self._sval(a), self._sval(b)
        if va is not None and vb is not None:
            if op == "add":
                return self._snode(("k", (va + vb) % gl.P))
            if op == "sub":
                return self._snode(("k", (va - vb) % gl.P))
            return self._snode(("k", (va * vb) % gl.P))
        if op in ("add", "mul") and a > b:
            a, b = b, a
        return self._snode((op, a, b))

    def _sneg(self, sid: int) -> int:
        return self._sop("sub", self._snode(("k", 0)), sid)

    # -- the vector graph ----------------------------------------------------

    def vector_input(self) -> EV:
        vid = len(self.vnodes)
        self.vnodes.append(("in", self.n_vector_inputs, None))
        self.n_vector_inputs += 1
        return EV("v", vid)

    def _vnode(self, op: int, x: int, y: int) -> EV:
        if op in (ADD, MUL) and x > y:
            x, y = y, x
        key = (op, x, y)
        vid = self._vcse.get(key)
        if vid is None:
            vid = len(self.vnodes)
            self.vnodes.append(key)
            self._vcse[key] = vid
        return EV("v", vid)

    # -- the algebra ---------------------------------------------------------

    def add(self, a: EV, b: EV) -> EV:
        if a.kind == "s" and b.kind == "s":
            return EV("s", self._sop("add", a.id, b.id))
        if a.kind == "s":
            a, b = b, a
        if b.kind == "s":
            if self._sval(b.id) == 0:
                return a
            return self._vnode(ADDS, a.id, b.id)
        return self._vnode(ADD, a.id, b.id)

    def sub(self, a: EV, b: EV) -> EV:
        if a.kind == "s" and b.kind == "s":
            return EV("s", self._sop("sub", a.id, b.id))
        if b.kind == "s":
            if self._sval(b.id) == 0:
                return a
            return self._vnode(ADDS, a.id, self._sneg(b.id))
        if a.kind == "s":
            return self._vnode(SUBS, b.id, a.id)
        if a.id == b.id:
            return self.sc_known(0)
        return self._vnode(SUB, a.id, b.id)

    def mul(self, a: EV, b: EV) -> EV:
        if a.kind == "s" and b.kind == "s":
            return EV("s", self._sop("mul", a.id, b.id))
        if a.kind == "s":
            a, b = b, a
        if b.kind == "s":
            v = self._sval(b.id)
            if v == 0:
                return self.sc_known(0)
            if v == 1:
                return a
            return self._vnode(MULS, a.id, b.id)
        return self._vnode(MUL, a.id, b.id)

    def mark_output(self, ev: EV) -> None:
        self.outputs.append(ev)

    # -- compilation ---------------------------------------------------------

    def compile(self, wave_width: int = 16) -> "ConstraintProgram":
        if any(ev.kind == "s" for ev in self.outputs):
            raise ValueError("scalar outputs unsupported; vectorize first")
        out_ids = [ev.id for ev in self.outputs]
        n = len(self.vnodes)

        # dead-code elimination: the live vector nodes, from the outputs
        live = np.zeros(n, dtype=bool)
        stack = list(out_ids)
        while stack:
            vid = stack.pop()
            if live[vid]:
                continue
            live[vid] = True
            op, x, y = self.vnodes[vid]
            if op == "in":
                continue
            stack.append(x)
            if op in (ADD, SUB, MUL):
                stack.append(y)

        # vector-operand use counts among the live nodes
        uses = np.zeros(n, dtype=np.int64)
        for vid in np.flatnonzero(live).tolist():
            op, x, y = self.vnodes[vid]
            if op == "in":
                continue
            uses[x] += 1
            if op in (ADD, SUB, MUL):
                uses[y] += 1
        for vid in out_ids:
            uses[vid] += 1

        # mul-add fusion: ADD(m, c) with m a MUL or MULS read once
        out_set = set(out_ids)
        fused_into: Dict[int, tuple] = {}
        consumed = np.zeros(n, dtype=bool)
        for vid in np.flatnonzero(live).tolist():
            op, x, y = self.vnodes[vid]
            if op != ADD:
                continue
            for m, other in ((x, y), (y, x)):
                mop, mx, my = self.vnodes[m]
                if (mop in (MUL, MULS) and uses[m] == 1 and m not in out_set
                        and not consumed[m]):
                    fused_into[vid] = (MULADD if mop == MUL else MULADDS,
                                       mx, my, other)
                    consumed[m] = True
                    break

        # the op list in creation (topological) order:
        # (opcode, dst vid, a, b, c)
        ops: List[tuple] = []
        for vid in np.flatnonzero(live & ~consumed).tolist():
            op, x, y = self.vnodes[vid]
            if op == "in":
                continue
            if vid in fused_into:
                ops.append((fused_into[vid][0], vid) + fused_into[vid][1:])
            else:
                ops.append((op, vid, x, y, 0))

        waves = _schedule_waves(ops, wave_width)
        return _allocate(self, ops, waves, out_ids, wave_width)


def _operand_vids(op: tuple) -> List[int]:
    code, _dst, a, b, c = op
    if code == MULADD:
        return [a, b, c]
    if code == MULADDS:
        return [a, c]
    if code in (ADD, SUB, MUL):
        return [a, b]
    return [a]                                  # ADDS, SUBS, MULS


def _schedule_waves(ops: List[tuple], W: int) -> List[List[int]]:
    """Greedy list scheduling into same-opcode waves of at most W ops: the
    opcode with the most ready ops (the lowest on a tie) takes its first W.
    An op may run in a wave only if its operands are inputs or were defined
    in strictly earlier waves (a wave reads all its operands before any
    write)."""
    n = len(ops)
    defop: Dict[int, int] = {op[1]: i for i, op in enumerate(ops)}
    indeg = np.zeros(n, dtype=np.int64)
    dependents: List[List[int]] = [[] for _ in range(n)]
    for i, op in enumerate(ops):
        for v in _operand_vids(op):
            j = defop.get(v)
            if j is not None:
                indeg[i] += 1
                dependents[j].append(i)

    ready: List[List[int]] = [[] for _ in range(N_OPCODES)]
    for i in range(n):
        if indeg[i] == 0:
            ready[ops[i][0]].append(i)
    waves: List[List[int]] = []
    done = 0
    while done < n:
        code = max(range(N_OPCODES), key=lambda c: len(ready[c]))
        if not ready[code]:
            raise ValueError("cycle in constraint program")
        take = ready[code][:W]
        ready[code] = ready[code][W:]
        waves.append(take)
        done += len(take)
        for i in take:                  # release dependents after the wave
            for j in dependents[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready[ops[j][0]].append(j)
    return waves


def _allocate(builder: ProgramBuilder, ops: List[tuple],
              waves: List[List[int]], out_ids: List[int],
              W: int) -> "ConstraintProgram":
    """Linear-scan register allocation over the wave schedule: a register
    whose value is last read in a wave is free for that wave's results (the
    most recently freed first); padded slots write the dump register,
    allocated last."""
    n_in = builder.n_vector_inputs
    reg_of: Dict[int, int] = {vid: x for vid, (op, x, _y)
                              in enumerate(builder.vnodes) if op == "in"}
    last_use: Dict[int, int] = {}
    for w, wave in enumerate(waves):
        for i in wave:
            for v in _operand_vids(ops[i]):
                last_use[v] = w
    expiring: Dict[int, List[int]] = {}
    for v, w in last_use.items():
        expiring.setdefault(w, []).append(v)
    out_set = set(out_ids)

    shape = (len(waves), W)
    wave_dst = np.full(shape, -1, dtype=np.int32)
    wave_a, wave_b, wave_c = (np.zeros(shape, dtype=np.int32)
                              for _ in range(3))
    wave_opcodes = np.zeros(len(waves), dtype=np.int32)
    bank_of: Dict[int, int] = {}
    bank_sids: List[int] = []

    def bank_slot(sid: int) -> int:
        if sid not in bank_of:
            bank_of[sid] = len(bank_sids)
            bank_sids.append(sid)
        return bank_of[sid]

    free: List[int] = []
    next_reg = n_in
    for w, wave in enumerate(waves):
        wave_opcodes[w] = ops[wave[0]][0]
        rows = []
        for i in wave:
            opc, dst, a, b, c = ops[i]
            if opc in (ADD, SUB, MUL):
                rb, rc = reg_of[b], 0
            elif opc == MULADD:
                rb, rc = reg_of[b], reg_of[c]
            elif opc == MULADDS:
                rb, rc = bank_slot(b), reg_of[c]
            else:                       # ADDS, SUBS, MULS: b is a scalar
                rb, rc = bank_slot(b), 0
            rows.append((dst, reg_of[a], rb, rc))
        # registers whose value dies in this wave (reads precede writes)
        for v in expiring.get(w, ()):
            if v not in out_set and v in reg_of:
                free.append(reg_of[v])
        for k, (dst, ra, rb, rc) in enumerate(rows):
            if free:
                rd = free.pop()
            else:
                rd = next_reg
                next_reg += 1
            reg_of[dst] = rd
            wave_dst[w, k], wave_a[w, k] = rd, ra
            wave_b[w, k], wave_c[w, k] = rb, rc
    dump = next_reg
    wave_dst[wave_dst < 0] = dump
    kind, ta, tb, tk = _tape_arrays(builder.snodes)
    return ConstraintProgram(
        n_inputs=n_in, n_regs=dump + 1, wave_width=W,
        wave_opcodes=wave_opcodes, wave_dst=wave_dst, wave_a=wave_a,
        wave_b=wave_b, wave_c=wave_c,
        out_regs=np.array([reg_of[v] for v in out_ids], dtype=np.int32),
        tape_kind=kind, tape_a=ta, tape_b=tb, tape_const=tk,
        bank_sids=np.array(bank_sids, dtype=np.int32),
        n_scalar_inputs=builder.n_scalar_inputs, n_ops=len(ops))


class ExprAlgebra:
    """The algebra (plonk/algebra.py) that records a program."""

    def __init__(self, builder: ProgramBuilder):
        self.b = builder

    def const(self, c: int) -> EV:
        return self.b.sc_known(c)

    def zero(self) -> EV:
        return self.b.sc_known(0)

    def one(self) -> EV:
        return self.b.sc_known(1)

    def add(self, a: EV, b: EV) -> EV:
        return self.b.add(a, b)

    def sub(self, a: EV, b: EV) -> EV:
        return self.b.sub(a, b)

    def mul(self, a: EV, b: EV) -> EV:
        return self.b.mul(a, b)

    def neg(self, a: EV) -> EV:
        return self.b.sub(self.b.sc_known(0), a)

    def add_const(self, a: EV, c: int) -> EV:
        return self.b.add(a, self.b.sc_known(c))

    def mul_const(self, a: EV, c: int) -> EV:
        return self.b.mul(a, self.b.sc_known(c))

    def exp(self, a: EV, e: int) -> EV:
        result = self.b.sc_known(1)
        base = a
        while e > 0:
            if e & 1:
                result = self.b.mul(result, base)
            e >>= 1
            if e:
                base = self.b.mul(base, base)
        return result

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


@functools.lru_cache(maxsize=32)
def linearize(prog: ConstraintProgram) -> LinearProgram:
    """The wave program as a straight stream of its real ops, for kernel K6.

    Ops no output depends on are dropped, and so are the padded slots.  The
    rest run in a greedy list schedule: of the ops whose operands are
    computed, the one that leaves the fewest values live (it frees the
    operands it reads last; an input it reads first takes a slot only if a
    later op reads it too), the latest in wave order on a tie (which
    finishes one chain of work before it starts the next).  Values then
    take the lowest free slot; an output's value stays in its slot to the
    end; last, the slots are renumbered busiest first.  Field arithmetic
    is exact, so any order gives the same outputs.  Deterministic; cached
    per program."""
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
    vreaders = {}         # value -> the ops that read it
    for k in order_in:
        for v in operands[k]:
            vreaders.setdefault(v, []).append(k)

    def term(v):
        if v in in_slot:
            return -(remaining[v] == 1)
        return int(remaining[v] > 1)        # an input read first, kept

    def delta(k):
        return 1 + sum(term(v) for v in operands[k])

    # the ready op of least (delta, -j) from a heap; an entry whose delta is
    # no longer the op's is stale and skipped, and an op's delta is pushed
    # anew whenever the term of one of its operands changes
    ready = set()
    key = {}
    heap = []

    def push(k):
        key[k] = delta(k)
        heapq.heappush(heap, (key[k], -k))

    for k in order_in:
        if pending[k] == 0:
            ready.add(k)
            push(k)
    schedule = []
    while heap:
        d, negk = heapq.heappop(heap)
        k = -negk
        if k not in ready or key[k] != d:
            continue
        ready.remove(k)
        schedule.append(k)
        changed = []
        for v in operands[k]:
            before = term(v) if remaining[v] else None
            remaining[v] -= 1
            if remaining[v] and v < n_in:
                in_slot.add(v)
            elif not remaining[v]:
                in_slot.discard(v)
            if remaining[v] and term(v) != before:
                changed.append(v)
        in_slot.add(n_in + k)
        for v in changed:
            for j in vreaders[v]:
                if j in ready:
                    push(j)
        for j in readers.get(n_in + k, ()):
            pending[j] -= 1
            if pending[j] == 0:
                ready.add(j)
                push(j)

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
    packed, input_slot, out_ops = _busiest_slots_first(
        packed, input_slot, out_ops, n_slots)
    return LinearProgram(
        ops=np.array(packed, dtype=np.uint64), n_slots=n_slots,
        input_rows=np.array(read_inputs, dtype=np.int32),
        input_slot=input_slot, out_operands=np.array(out_ops, np.int32),
        n_inputs=n_in)


def _busiest_slots_first(packed, input_slot, out_ops, n_slots):
    """The slots renumbered by how often the ops read and write them, most
    first (the lower number on a tie): K6 keeps the lowest-numbered slots
    in shared memory when not all of them fit."""
    def slots_of(f):
        return [] if f & OPERAND_INPUT else [f]

    count = [0] * n_slots
    for op in packed:
        code = op & 15
        fa, fb, fc = (op >> 16) & 0xFFFF, (op >> 32) & 0xFFFF, op >> 48
        used = [(op >> 4) & 0xFFF] + slots_of(fa)
        if code not in SCALAR_B:
            used += slots_of(fb)
        if code in (MULADD, MULADDS):
            used += slots_of(fc)
        for sl in used:
            count[sl] += 1
    for sl in input_slot.tolist():
        if sl >= 0:
            count[sl] += 1                  # the store at the first read
    for f in out_ops:
        for sl in slots_of(f):
            count[sl] += 1
    order = sorted(range(n_slots), key=lambda sl: (-count[sl], sl))
    new = [0] * n_slots
    for rank, sl in enumerate(order):
        new[sl] = rank

    def operand(f):
        return f if f & OPERAND_INPUT else new[f]

    out = []
    for op in packed:
        code = op & 15
        fa, fb, fc = (op >> 16) & 0xFFFF, (op >> 32) & 0xFFFF, op >> 48
        fb = fb if code in SCALAR_B else operand(fb)
        fc = operand(fc) if code in (MULADD, MULADDS) else fc
        out.append(code | new[(op >> 4) & 0xFFF] << 4 | operand(fa) << 16
                   | fb << 32 | fc << 48)
    slots = np.array([new[sl] if sl >= 0 else -1
                      for sl in input_slot.tolist()], dtype=np.int32)
    return out, slots, [operand(f) for f in out_ops]


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

def _tape_arrays(snodes) -> tuple:
    """(kind int8, a int32, b int32, const uint64) arrays of a scalar tape
    given as ('k', value) | ('in', slot) | (op, a_sid, b_sid) records."""
    kinds, ta, tb, tk = [], [], [], []
    for rec in snodes:
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
    return (np.asarray(kinds, dtype=np.int8), np.asarray(ta, dtype=np.int32),
            np.asarray(tb, dtype=np.int32), np.asarray(tk, dtype=np.uint64))


def program_from_arrays(obj) -> ConstraintProgram:
    """A port program from any object with the JAX ``ConstraintProgram``'s
    attributes (read by name; nothing of the JAX package is imported)."""
    kinds, ta, tb, tk = _tape_arrays(obj.snodes)
    i32 = lambda x: np.asarray(x, dtype=np.int32)  # noqa: E731
    return ConstraintProgram(
        n_inputs=int(obj.n_inputs), n_regs=int(obj.n_regs),
        wave_width=int(obj.wave_width),
        wave_opcodes=i32(obj.wave_opcodes), wave_dst=i32(obj.wave_dst),
        wave_a=i32(obj.wave_a), wave_b=i32(obj.wave_b),
        wave_c=i32(obj.wave_c), out_regs=i32(obj.out_regs),
        tape_kind=kinds, tape_a=ta, tape_b=tb, tape_const=tk,
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


WIDE_VALUES = 1600      # wide_program's values
WIDE_INPUTS = 64        # and its vector inputs


def wide_program() -> ConstraintProgram:
    """A compiled program that keeps about WIDE_VALUES / 2 values live at
    once, for checking kernel K6 on programs wider than shared memory
    holds: WIDE_VALUES products of inputs (each plus a scalar; the pairs
    from numpy seed 0), then one chain acc = acc * v[i] + v[n - i] that
    reads each value twice, far apart.  Two outputs: the chain and the
    sum of the values' squares."""
    n_values = WIDE_VALUES
    rng = np.random.default_rng(0)
    b = ProgramBuilder()
    alg = ExprAlgebra(b)
    xs = [b.vector_input() for _ in range(WIDE_INPUTS)]
    ss = [b.scalar_input() for _ in range(4)]
    pick = rng.integers(0, WIDE_INPUTS, size=(n_values, 2))
    vals = [alg.add(alg.mul(xs[i], xs[j]), ss[k % 4])
            for k, (i, j) in enumerate(pick.tolist())]
    acc = vals[0]
    for i in range(1, n_values):
        acc = alg.add(alg.mul(acc, vals[i]), vals[n_values - i])
    sq = alg.zero()
    for v in vals[::7]:
        sq = alg.add(sq, alg.mul(v, v))
    b.mark_output(acc)
    b.mark_output(sq)
    return b.compile()
