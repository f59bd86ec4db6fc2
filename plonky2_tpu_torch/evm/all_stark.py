"""The four tables {keccak-f, keccak sponge, logic, memory} joined by live
cross-table lookups, and their consistent witness from a list of sponge
operations.  The port's counterpart of the four-table part of
plonky2_tpu/evm/all_stark.py (reference evm/src/all_stark.rs:24-160,
whose CTLs ship disabled; here they are live and verified):

- ctl_keccak: sponge rows look up (preimage, output) in the keccak table;
- ctl_logic: each sponge row does 5 32-byte XOR lookups in the logic
  table (with the op-row filter, so all five chunks are looked up on
  every absorb row);
- ctl_memory: one lookup per input byte read from memory.
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import keccak_sponge as sponge_mod
from . import keccak_stark as keccak_mod
from . import logic as logic_mod
from . import memory as memory_mod
from .cross_table_lookup import CrossTableLookup, TableWithColumns
from .keccak_sponge import KECCAK_RATE_BYTES, KeccakSpongeOp, KeccakSpongeStark
from .keccak_stark import KeccakStark
from .logic import LogicStark, Operation as LogicOp
from .memory import MemoryOp, MemoryStark
from .prover import AllStark

KECCAK = 0
KECCAK_SPONGE = 1
LOGIC = 2
MEMORY = 3


def ctl_keccak() -> CrossTableLookup:
    """(reference all_stark.rs:108-120)."""
    looking = TableWithColumns(
        table=KECCAK_SPONGE, columns=sponge_mod.ctl_looking_keccak(),
        filter_column=sponge_mod.ctl_looking_keccak_filter())
    looked = TableWithColumns(table=KECCAK, columns=keccak_mod.ctl_data(),
                              filter_column=keccak_mod.ctl_filter())
    return CrossTableLookup(looking_tables=[looking], looked_table=looked)


def ctl_logic() -> CrossTableLookup:
    """(reference all_stark.rs:136-154)."""
    lookers = [TableWithColumns(
        table=KECCAK_SPONGE, columns=sponge_mod.ctl_looking_logic(i),
        filter_column=sponge_mod.ctl_looking_logic_filter())
        for i in range(sponge_mod.num_logic_ctls())]
    looked = TableWithColumns(table=LOGIC, columns=logic_mod.ctl_data(),
                              filter_column=logic_mod.ctl_filter())
    return CrossTableLookup(looking_tables=lookers, looked_table=looked)


def ctl_memory() -> CrossTableLookup:
    """(reference all_stark.rs:156-177)."""
    lookers = [TableWithColumns(
        table=KECCAK_SPONGE, columns=sponge_mod.ctl_looking_memory(i),
        filter_column=sponge_mod.ctl_looking_memory_filter(i))
        for i in range(KECCAK_RATE_BYTES)]
    looked = TableWithColumns(table=MEMORY, columns=memory_mod.ctl_data(),
                              filter_column=memory_mod.ctl_filter())
    return CrossTableLookup(looking_tables=lookers, looked_table=looked)


def all_cross_table_lookups() -> List[CrossTableLookup]:
    return [ctl_keccak(), ctl_logic(), ctl_memory()]


def make_all_stark() -> AllStark:
    return AllStark(
        starks=[KeccakStark(), KeccakSpongeStark(), LogicStark(),
                MemoryStark()],
        cross_table_lookups=all_cross_table_lookups())


def _sponge_derived_witness(sponge_trace: np.ndarray):
    """The keccak-f inputs, logic XOR ops and memory reads that the sponge
    trace implies (the role of reference generation/ for these tables)."""
    keccak_inputs: List[List[int]] = []
    logic_ops: List[LogicOp] = []
    memory_ops: List[MemoryOp] = []
    rows = np.flatnonzero(sponge_trace[sponge_mod.IS_FULL_INPUT_BLOCK]
                          | sponge_trace[sponge_mod.IS_FINAL_BLOCK])
    for j in rows.tolist():
        col = sponge_trace[:, j].tolist()
        is_full = col[sponge_mod.IS_FULL_INPUT_BLOCK]
        state_u32s = ([col[c] for c in sponge_mod.XORED_RATE_U32S]
                      + [col[c] for c in sponge_mod.ORIGINAL_CAPACITY_U32S])
        keccak_inputs.append([state_u32s[2 * i] | (state_u32s[2 * i + 1] << 32)
                              for i in range(25)])
        orig_rate = [col[c] for c in sponge_mod.ORIGINAL_RATE_U32S]
        block = bytes(col[c] for c in sponge_mod.BLOCK_BYTES)
        for i in range(sponge_mod.num_logic_ctls()):
            in0 = sum(v << (32 * k)
                      for k, v in enumerate(orig_rate[8 * i:8 * i + 8]))
            in1 = int.from_bytes(block[32 * i:32 * i + 32], "little")
            logic_ops.append(LogicOp("xor", in0, in1))
        ctx, seg = col[sponge_mod.CONTEXT], col[sponge_mod.SEGMENT]
        virt, ts = col[sponge_mod.VIRT], col[sponge_mod.TIMESTAMP]
        absorbed = col[sponge_mod.ALREADY_ABSORBED_BYTES]
        n_bytes = (KECCAK_RATE_BYTES if is_full
                   else col[sponge_mod.LEN] - absorbed)
        for i in range(n_bytes):
            memory_ops.append(MemoryOp(
                filter=True, timestamp=ts, is_read=True, context=ctx,
                segment=seg, virt=virt + absorbed + i, value=block[i]))
    return keccak_inputs, logic_ops, memory_ops


def generate_all_traces(ops: List[KeccakSpongeOp],
                        min_rows: int = 8) -> List[np.ndarray]:
    """The four tables' (COLUMNS, rows) uint64 traces, consistent across
    the tables, from sponge operations."""
    sponge_trace = KeccakSpongeStark().generate_trace(ops, min_rows=min_rows)
    keccak_inputs, logic_ops, memory_ops = \
        _sponge_derived_witness(sponge_trace)
    keccak_trace = KeccakStark().generate_trace(keccak_inputs,
                                                min_rows=min_rows)
    logic_trace = LogicStark().generate_trace(logic_ops, min_rows=min_rows)
    memory_trace = MemoryStark().generate_trace(memory_ops)
    return [keccak_trace, sponge_trace, logic_trace, memory_trace]
