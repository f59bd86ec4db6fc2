"""The memory table: operations sorted by (context, segment, virtual,
timestamp) with first-change flags, the ordering deltas range-checked by
a lookup against a counter column, and read consistency.  The port's copy
of plonky2_tpu/evm/memory.py (reference
evm/src/memory/{columns,memory_stark,segments}.rs), the per-row part of
its trace generator written with numpy array ops."""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum
from typing import List

import numpy as np

from ..stark.stark import PermutationPair, Stark
from ..system_zero.lookup import permuted_cols
from .cross_table_lookup import Column

VALUE_LIMBS = 8

FILTER = 0
TIMESTAMP = FILTER + 1
IS_READ = TIMESTAMP + 1
ADDR_CONTEXT = IS_READ + 1
ADDR_SEGMENT = ADDR_CONTEXT + 1
ADDR_VIRTUAL = ADDR_SEGMENT + 1
VALUE_START = ADDR_VIRTUAL + 1


def value_limb(i: int) -> int:
    return VALUE_START + i


CONTEXT_FIRST_CHANGE = VALUE_START + VALUE_LIMBS
SEGMENT_FIRST_CHANGE = CONTEXT_FIRST_CHANGE + 1
VIRTUAL_FIRST_CHANGE = SEGMENT_FIRST_CHANGE + 1
RANGE_CHECK = VIRTUAL_FIRST_CHANGE + 1
COUNTER = RANGE_CHECK + 1
RANGE_CHECK_PERMUTED = COUNTER + 1
COUNTER_PERMUTED = RANGE_CHECK_PERMUTED + 1
NUM_COLUMNS = COUNTER_PERMUTED + 1


class Segment(IntEnum):
    """(reference memory/segments.rs:3-42)."""
    Code = 0
    Stack = 1
    MainMemory = 2
    Calldata = 3
    Returndata = 4
    GlobalMetadata = 5
    ContextMetadata = 6
    KernelGeneral = 7
    KernelGeneral2 = 8
    KernelAccountCode = 9
    TxnFields = 10
    TxnData = 11
    RlpRaw = 12
    TrieData = 13
    TrieEncodedChild = 14
    TrieEncodedChildLen = 15
    ShiftTable = 16
    JumpdestBits = 17


def ctl_data() -> List[Column]:
    res = Column.singles([IS_READ, ADDR_CONTEXT, ADDR_SEGMENT, ADDR_VIRTUAL])
    res += Column.singles([value_limb(i) for i in range(VALUE_LIMBS)])
    res.append(Column.single(TIMESTAMP))
    return res


def ctl_filter() -> Column:
    return Column.single(FILTER)


@dataclass(frozen=True)
class MemoryOp:
    filter: bool
    timestamp: int
    is_read: bool
    context: int
    segment: int
    virt: int
    value: int  # 256-bit

    def sorting_key(self):
        return (self.context, self.segment, self.virt, self.timestamp)


def dummy_read(context, segment, virt, timestamp, value=0) -> MemoryOp:
    return MemoryOp(filter=False, timestamp=timestamp, is_read=True,
                    context=context, segment=segment, virt=virt, value=value)


class MemoryStark(Stark):
    COLUMNS = NUM_COLUMNS
    PUBLIC_INPUTS = 0

    def generate_trace(self, memory_ops: List[MemoryOp]) -> np.ndarray:
        ops = sorted(memory_ops, key=MemoryOp.sorting_key)
        ops = self._fill_gaps(ops)
        ops = self._pad(ops)
        ops.sort(key=MemoryOp.sorting_key)

        n = len(ops)
        trace = np.zeros((NUM_COLUMNS, n), dtype=np.uint64)
        fields = np.array([(int(op.filter), op.timestamp, int(op.is_read),
                            op.context, op.segment, op.virt) for op in ops],
                          dtype=np.uint64).T
        trace[[FILTER, TIMESTAMP, IS_READ, ADDR_CONTEXT, ADDR_SEGMENT,
               ADDR_VIRTUAL]] = fields
        values = np.frombuffer(b"".join(op.value.to_bytes(4 * VALUE_LIMBS,
                                                          "little")
                                        for op in ops),
                               dtype="<u4").reshape(n, VALUE_LIMBS)
        trace[VALUE_START:VALUE_START + VALUE_LIMBS] = values.T

        # first-change flags + range-check deltas
        # (reference memory_stark.rs:71-116)
        ctx, seg, virt, ts = (trace[c].astype(np.int64) for c in (
            ADDR_CONTEXT, ADDR_SEGMENT, ADDR_VIRTUAL, TIMESTAMP))
        cfc = ctx[:-1] != ctx[1:]
        sfc = (seg[:-1] != seg[1:]) & ~cfc
        vfc = (virt[:-1] != virt[1:]) & ~sfc & ~cfc
        rc = np.where(cfc, ctx[1:] - ctx[:-1] - 1, np.where(
            sfc, seg[1:] - seg[:-1] - 1, np.where(
                vfc, virt[1:] - virt[:-1] - 1, ts[1:] - ts[:-1])))
        if np.any((rc < 0) | (rc >= n)):
            raise ValueError("a range check is too large; bug in fill_gaps?")
        trace[CONTEXT_FIRST_CHANGE, :-1] = cfc
        trace[SEGMENT_FIRST_CHANGE, :-1] = sfc
        trace[VIRTUAL_FIRST_CHANGE, :-1] = vfc
        trace[RANGE_CHECK, :-1] = rc

        # The read-consistency constraint is a full-row constraint, so it
        # also binds the wrap-around (last row -> first row). Mark the last
        # row as a context change so address_unchanged is 0 there; otherwise
        # a trace whose first sorted op is a read would be rejected (latent
        # in the reference too, memory_stark.rs:315, masked by its traces
        # always starting with bootstrap writes).
        trace[CONTEXT_FIRST_CHANGE, n - 1] = 1

        trace[COUNTER] = np.arange(n, dtype=np.uint64)
        pi, pt = permuted_cols(trace[RANGE_CHECK], trace[COUNTER])
        trace[RANGE_CHECK_PERMUTED] = pi
        trace[COUNTER_PERMUTED] = pt
        return trace

    @staticmethod
    def _fill_gaps(ops: List[MemoryOp]) -> List[MemoryOp]:
        """Insert dummy reads so every ordering delta fits the range check
        (reference memory_stark.rs:153-181)."""
        max_rc = (1 << (max(len(ops), 2) - 1).bit_length()) - 1
        extra = []
        for curr, nxt in zip(ops, ops[1:]):
            if (curr.context != nxt.context or curr.segment != nxt.segment):
                continue
            if curr.virt != nxt.virt:
                while nxt.virt - curr.virt - 1 > max_rc:
                    curr = dummy_read(curr.context, curr.segment,
                                      curr.virt + max_rc + 1, 0)
                    extra.append(curr)
            else:
                while nxt.timestamp - curr.timestamp > max_rc:
                    curr = dummy_read(curr.context, curr.segment, curr.virt,
                                      curr.timestamp + max_rc,
                                      value=curr.value)
                    extra.append(curr)
        return ops + extra

    @staticmethod
    def _pad(ops: List[MemoryOp]) -> List[MemoryOp]:
        last = ops[-1]
        pad = MemoryOp(filter=False, timestamp=last.timestamp, is_read=True,
                       context=last.context, segment=last.segment,
                       virt=last.virt, value=last.value)
        n = len(ops)
        target = 1 << (n - 1).bit_length()
        target = max(target, 8)
        return ops + [pad] * (target - n)

    def eval(self, alg, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = alg.one()

        filt = lv[FILTER]
        yield_constr.constraint(alg.mul(filt, alg.sub(filt, one)))

        # dummy rows must be reads (a prover may insert reads, never writes)
        is_dummy = alg.sub(one, filt)
        is_write = alg.sub(one, lv[IS_READ])
        yield_constr.constraint(alg.mul(is_dummy, is_write))

        cfc = lv[CONTEXT_FIRST_CHANGE]
        sfc = lv[SEGMENT_FIRST_CHANGE]
        vfc = lv[VIRTUAL_FIRST_CHANGE]
        unchanged = alg.sub(alg.sub(alg.sub(one, cfc), sfc), vfc)

        for flag in (cfc, sfc, vfc, unchanged):
            yield_constr.constraint(alg.mul(flag, alg.sub(one, flag)))

        ctx_diff = alg.sub(nv[ADDR_CONTEXT], lv[ADDR_CONTEXT])
        seg_diff = alg.sub(nv[ADDR_SEGMENT], lv[ADDR_SEGMENT])
        virt_diff = alg.sub(nv[ADDR_VIRTUAL], lv[ADDR_VIRTUAL])
        ts_diff = alg.sub(nv[TIMESTAMP], lv[TIMESTAMP])

        # fields before the first-change column must be unchanged
        yield_constr.constraint_transition(alg.mul(sfc, ctx_diff))
        yield_constr.constraint_transition(alg.mul(vfc, ctx_diff))
        yield_constr.constraint_transition(alg.mul(vfc, seg_diff))
        yield_constr.constraint_transition(alg.mul(unchanged, ctx_diff))
        yield_constr.constraint_transition(alg.mul(unchanged, seg_diff))
        yield_constr.constraint_transition(alg.mul(unchanged, virt_diff))

        # the column that should increase is range-checked via RANGE_CHECK
        computed_rc = alg.add(
            alg.add(alg.mul(cfc, alg.sub(ctx_diff, one)),
                    alg.mul(sfc, alg.sub(seg_diff, one))),
            alg.add(alg.mul(vfc, alg.sub(virt_diff, one)),
                    alg.mul(unchanged, ts_diff)))
        yield_constr.constraint_transition(
            alg.sub(lv[RANGE_CHECK], computed_rc))

        # reads at an unchanged address preserve the value
        for i in range(VALUE_LIMBS):
            yield_constr.constraint(
                alg.mul(nv[IS_READ],
                        alg.mul(unchanged,
                                alg.sub(nv[value_limb(i)],
                                        lv[value_limb(i)]))))

        # counter column is the range table 0..n-1 (the reference leaves it
        # unconstrained; we pin it down)
        yield_constr.constraint_first_row(lv[COUNTER])
        yield_constr.constraint_transition(
            alg.sub(alg.sub(nv[COUNTER], lv[COUNTER]), one))

        # Halo2 lookup: RANGE_CHECK values appear in COUNTER
        local_perm_input = lv[RANGE_CHECK_PERMUTED]
        next_perm_input = nv[RANGE_CHECK_PERMUTED]
        next_perm_table = nv[COUNTER_PERMUTED]
        diff_prev = alg.sub(next_perm_input, local_perm_input)
        diff_table = alg.sub(next_perm_input, next_perm_table)
        yield_constr.constraint(alg.mul(diff_prev, diff_table))
        yield_constr.constraint_last_row(diff_table)

    def constraint_degree(self) -> int:
        return 3

    def permutation_pairs(self):
        return [PermutationPair.singletons(RANGE_CHECK, RANGE_CHECK_PERMUTED),
                PermutationPair.singletons(COUNTER, COUNTER_PERMUTED)]
