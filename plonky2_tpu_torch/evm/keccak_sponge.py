"""The Keccak sponge table: absorbs byte blocks read from memory into
Keccak-f[1600], with the rate's XOR looked up in the logic table and the
permutation in the keccak table.  The port's copy of
plonky2_tpu/evm/keccak_sponge.py (reference
evm/src/keccak_sponge/{columns,keccak_sponge_stark}.rs): its column
layout, CTL columns, trace generator and constraints (the boolean flags,
the final-length one-hot, fresh-state initialisation, full-block chaining,
dummy rows only at the end, the final-length identity)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..hash.keccak import keccak_f1600
from ..stark.stark import Stark
from .cross_table_lookup import Column

KECCAK_WIDTH_BYTES = 200
KECCAK_WIDTH_U32S = KECCAK_WIDTH_BYTES // 4   # 50
KECCAK_RATE_BYTES = 136
KECCAK_RATE_U32S = KECCAK_RATE_BYTES // 4     # 34
KECCAK_CAPACITY_U32S = (KECCAK_WIDTH_BYTES - KECCAK_RATE_BYTES) // 4  # 16

# --- column layout (reference keccak_sponge/columns.rs:14-62) -------------

IS_FULL_INPUT_BLOCK = 0
IS_FINAL_BLOCK = 1
CONTEXT = 2
SEGMENT = 3
VIRT = 4
TIMESTAMP = 5
LEN = 6
ALREADY_ABSORBED_BYTES = 7
IS_FINAL_INPUT_LEN = range(8, 8 + KECCAK_RATE_BYTES)
ORIGINAL_RATE_U32S = range(IS_FINAL_INPUT_LEN.stop,
                           IS_FINAL_INPUT_LEN.stop + KECCAK_RATE_U32S)
ORIGINAL_CAPACITY_U32S = range(ORIGINAL_RATE_U32S.stop,
                               ORIGINAL_RATE_U32S.stop + KECCAK_CAPACITY_U32S)
BLOCK_BYTES = range(ORIGINAL_CAPACITY_U32S.stop,
                    ORIGINAL_CAPACITY_U32S.stop + KECCAK_RATE_BYTES)
XORED_RATE_U32S = range(BLOCK_BYTES.stop, BLOCK_BYTES.stop + KECCAK_RATE_U32S)
UPDATED_STATE_U32S = range(XORED_RATE_U32S.stop,
                           XORED_RATE_U32S.stop + KECCAK_WIDTH_U32S)
NUM_KECCAK_SPONGE_COLUMNS = UPDATED_STATE_U32S.stop


# --- CTL columns (reference keccak_sponge_stark.rs:26-147) ----------------

def ctl_looked_data() -> List[Column]:
    """What the CPU looks up: address, length, timestamp, 256-bit digest."""
    return (Column.singles([CONTEXT, SEGMENT, VIRT, LEN, TIMESTAMP])
            + Column.singles(list(UPDATED_STATE_U32S)[:8]))


def ctl_looked_filter() -> Column:
    return Column.single(IS_FINAL_BLOCK)


def ctl_looking_keccak() -> List[Column]:
    """Row sent to the keccak-f table: permutation input and output.  The
    permutation's input rate is the POST-xor rate; the reference sends
    original_rate_u32s here (keccak_sponge_stark.rs:40-51), which can never
    match the keccak table (another artifact of its disabled CTLs)."""
    return Column.singles(list(XORED_RATE_U32S)
                          + list(ORIGINAL_CAPACITY_U32S)
                          + list(UPDATED_STATE_U32S))


def ctl_looking_keccak_filter() -> Column:
    return Column.sum_cols([IS_FULL_INPUT_BLOCK, IS_FINAL_BLOCK])


def ctl_looking_memory(i: int) -> List[Column]:
    """The i'th byte read: (is_read=1, ctx, seg, virt+absorbed+i, byte,
    0*7, timestamp), matching memory.ctl_data's shape."""
    res = [Column.constant_col(1)]
    res += Column.singles([CONTEXT, SEGMENT])
    res.append(Column([(VIRT, 1), (ALREADY_ABSORBED_BYTES, 1)], constant=i))
    res.append(Column.single(BLOCK_BYTES[i]))
    res += [Column.constant_col(0) for _ in range(7)]
    res.append(Column.single(TIMESTAMP))
    return res


def ctl_looking_memory_filter(i: int) -> Column:
    """Byte i is read on full blocks, or final blocks of length > i.
    A final block of length L reads bytes 0..L-1, so byte i needs
    is_final_input_len[i+1..]; the reference's [i..] slice
    (keccak_sponge_stark.rs:135-142) also fires on the first padding
    byte."""
    return Column.sum_cols([IS_FULL_INPUT_BLOCK]
                           + list(IS_FINAL_INPUT_LEN)[i + 1:])


U32S_PER_CTL = 8
U8S_PER_CTL = 32


def num_logic_ctls() -> int:
    return -(-KECCAK_RATE_BYTES // U8S_PER_CTL)  # 5


def ctl_looking_logic(i: int) -> List[Column]:
    """The i'th 32-byte XOR against the logic table: original rate chunk
    XOR block chunk == xored rate chunk (reference :88-127)."""
    assert i < num_logic_ctls()
    res = [Column.constant_col(0), Column.constant_col(0), Column.constant_col(1)]

    def take8(cols):
        cols = list(cols)
        return cols + [None] * (U32S_PER_CTL - len(cols))

    for c in take8(list(ORIGINAL_RATE_U32S)[i * U32S_PER_CTL:
                                            (i + 1) * U32S_PER_CTL]):
        res.append(Column.constant_col(0) if c is None else Column.single(c))
    byte_cols = list(BLOCK_BYTES)[i * U8S_PER_CTL:(i + 1) * U8S_PER_CTL]
    chunks = [byte_cols[k:k + 4] for k in range(0, len(byte_cols), 4)]
    for k in range(U32S_PER_CTL):
        res.append(Column.le_bytes(chunks[k]) if k < len(chunks)
                   else Column.constant_col(0))
    for c in take8(list(XORED_RATE_U32S)[i * U32S_PER_CTL:
                                         (i + 1) * U32S_PER_CTL]):
        res.append(Column.constant_col(0) if c is None else Column.single(c))
    return res


def ctl_looking_logic_filter() -> Column:
    return Column.sum_cols([IS_FULL_INPUT_BLOCK, IS_FINAL_BLOCK])


# --- witness generation ---------------------------------------------------

def _keccakf_u32s(state_u32s: List[int]) -> List[int]:
    """keccak-f[1600] on 50 little-endian u32 half-lanes
    (reference cpu/kernel/keccak_util.rs keccakf_u32s)."""
    lanes = [state_u32s[2 * i] | (state_u32s[2 * i + 1] << 32)
             for i in range(25)]
    lanes = keccak_f1600(lanes)
    out = []
    for lane in lanes:
        out.append(lane & 0xFFFFFFFF)
        out.append(lane >> 32)
    return out


@dataclass
class KeccakSpongeOp:
    """(reference keccak_sponge_stark.rs:149-159)."""
    context: int
    segment: int
    virt: int
    timestamp: int
    input: bytes


class KeccakSpongeStark(Stark):
    COLUMNS = NUM_KECCAK_SPONGE_COLUMNS
    PUBLIC_INPUTS = 0

    def generate_trace(self, operations: List[KeccakSpongeOp],
                       min_rows: int = 8) -> np.ndarray:
        rows: List[np.ndarray] = []
        for op in operations:
            rows += self._rows_for_op(op)
        n = max(len(rows), min_rows)
        n = 1 << (n - 1).bit_length()
        trace = np.zeros((NUM_KECCAK_SPONGE_COLUMNS, n), dtype=np.uint64)
        for j, row in enumerate(rows):
            trace[:, j] = row
        return trace

    def _rows_for_op(self, op: KeccakSpongeOp) -> List[np.ndarray]:
        rows = []
        state = [0] * KECCAK_WIDTH_U32S
        data = op.input
        absorbed = 0
        while len(data) - absorbed >= KECCAK_RATE_BYTES:
            block = data[absorbed:absorbed + KECCAK_RATE_BYTES]
            row, state = self._make_row(op, absorbed, state, block,
                                        final=False)
            rows.append(row)
            absorbed += KECCAK_RATE_BYTES
        # final (padded) block, pad10*1 (reference :262-283)
        final_inputs = data[absorbed:]
        block = bytearray(final_inputs) + bytearray(
            KECCAK_RATE_BYTES - len(final_inputs))
        if len(final_inputs) == KECCAK_RATE_BYTES - 1:
            block[len(final_inputs)] = 0b10000001
        else:
            block[len(final_inputs)] = 1
            block[KECCAK_RATE_BYTES - 1] |= 0b10000000
        row, _ = self._make_row(op, absorbed, state, bytes(block), final=True,
                                final_len=len(final_inputs))
        rows.append(row)
        return rows

    def _make_row(self, op, absorbed, state, block, final, final_len=None):
        row = np.zeros(NUM_KECCAK_SPONGE_COLUMNS, dtype=np.uint64)
        row[IS_FINAL_BLOCK if final else IS_FULL_INPUT_BLOCK] = 1
        row[CONTEXT], row[SEGMENT] = op.context, op.segment
        row[VIRT], row[TIMESTAMP] = op.virt, op.timestamp
        row[LEN] = len(op.input)
        row[ALREADY_ABSORBED_BYTES] = absorbed
        if final:
            row[IS_FINAL_INPUT_LEN[final_len]] = 1
        for i, b in enumerate(block):
            row[BLOCK_BYTES[i]] = b
        for i, c in enumerate(ORIGINAL_RATE_U32S):
            row[c] = state[i]
        for i, c in enumerate(ORIGINAL_CAPACITY_U32S):
            row[c] = state[KECCAK_RATE_U32S + i]
        block_u32s = [int.from_bytes(block[4 * i:4 * i + 4], "little")
                      for i in range(KECCAK_RATE_U32S)]
        state = list(state)
        for i in range(KECCAK_RATE_U32S):
            state[i] ^= block_u32s[i]
            row[XORED_RATE_U32S[i]] = state[i]
        state = _keccakf_u32s(state)
        for i, c in enumerate(UPDATED_STATE_U32S):
            row[c] = state[i]
        return row, state

    def digest(self, trace: np.ndarray, row: int) -> bytes:
        """256-bit sponge output of the final-block row `row`."""
        assert trace[IS_FINAL_BLOCK, row] == 1
        out = b""
        for c in list(UPDATED_STATE_U32S)[:8]:
            out += int(trace[c, row]).to_bytes(4, "little")
        return out

    # --- constraints (the reference's TODO list, implemented) -------------

    def eval(self, alg, vars, yield_constr) -> None:
        lv, nv = vars.local_values, vars.next_values
        one = alg.one()
        is_full = lv[IS_FULL_INPUT_BLOCK]
        is_final = lv[IS_FINAL_BLOCK]
        filt = alg.add(is_full, is_final)

        def boolean(x):
            yield_constr.constraint(alg.mul(x, alg.sub(x, one)))

        boolean(is_full)
        boolean(is_final)
        yield_constr.constraint(alg.mul(is_full, is_final))
        final_len_sum = alg.zero()
        for c in IS_FINAL_INPUT_LEN:
            boolean(lv[c])
            final_len_sum = alg.add(final_len_sum, lv[c])
        yield_constr.constraint(alg.sub(final_len_sum, is_final))

        # is_final_input_len[i] = 1 implies len - already_absorbed = i
        for i, c in enumerate(IS_FINAL_INPUT_LEN):
            delta = alg.sub(lv[LEN], lv[ALREADY_ABSORBED_BYTES])
            yield_constr.constraint(
                alg.mul(lv[c], alg.sub(delta, alg.const(i))))

        # an operation starting on the first row starts from a fresh sponge
        for c in list(ORIGINAL_RATE_U32S) + list(ORIGINAL_CAPACITY_U32S):
            yield_constr.constraint_first_row(alg.mul(filt, lv[c]))
        yield_constr.constraint_first_row(
            alg.mul(filt, lv[ALREADY_ABSORBED_BYTES]))

        # after a final block, the next op row starts from a fresh sponge
        for c in list(ORIGINAL_RATE_U32S) + list(ORIGINAL_CAPACITY_U32S):
            yield_constr.constraint_transition(alg.mul(is_final, nv[c]))
        yield_constr.constraint_transition(
            alg.mul(is_final, nv[ALREADY_ABSORBED_BYTES]))

        # full-input blocks chain into the next row
        nxt_filt = alg.add(nv[IS_FULL_INPUT_BLOCK], nv[IS_FINAL_BLOCK])
        yield_constr.constraint_transition(
            alg.mul(is_full, alg.sub(one, nxt_filt)))
        for a, b in ((CONTEXT, CONTEXT), (SEGMENT, SEGMENT), (VIRT, VIRT),
                     (TIMESTAMP, TIMESTAMP), (LEN, LEN)):
            yield_constr.constraint_transition(
                alg.mul(is_full, alg.sub(nv[b], lv[a])))
        yield_constr.constraint_transition(alg.mul(
            is_full, alg.sub(nv[ALREADY_ABSORBED_BYTES],
                             alg.add(lv[ALREADY_ABSORBED_BYTES],
                                     alg.const(KECCAK_RATE_BYTES)))))
        for i in range(KECCAK_WIDTH_U32S):
            nxt_orig = (nv[ORIGINAL_RATE_U32S[i]] if i < KECCAK_RATE_U32S
                        else nv[ORIGINAL_CAPACITY_U32S[i - KECCAK_RATE_U32S]])
            yield_constr.constraint_transition(alg.mul(
                is_full, alg.sub(nxt_orig, lv[UPDATED_STATE_U32S[i]])))

        # dummy rows only pad the end: a dummy row is followed by a dummy row
        dummy = alg.sub(one, filt)
        yield_constr.constraint_transition(alg.mul(dummy, nxt_filt))

    def constraint_degree(self) -> int:
        return 3
