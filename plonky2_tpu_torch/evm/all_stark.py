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

With the CPU (the six tables of a block proof, table indices in
``CPU_TABLES``) the CPU also looks up its opcode fetches and its five
general channels in the memory table, its AND/OR/XOR rows in the logic
table, its KECCAK_GENERAL digests in the sponge table and its ADD/MUL/SUB/
LT/GT, ADDMOD/MULMOD, DIV and MOD results in the arithmetic table.
"""
from __future__ import annotations

from typing import List

import numpy as np

from . import arithmetic as arith_mod
from . import cpu as cpu_mod
from . import keccak_sponge as sponge_mod
from . import keccak_stark as keccak_mod
from . import logic as logic_mod
from . import memory as memory_mod
from .arithmetic import RC_MIN_ROWS, ArithmeticStark
from .cpu import CpuStark, generate_bootstrap_kernel
from .cross_table_lookup import CrossTableLookup, TableWithColumns
from .generation import generate_kernel_execution
from .keccak_sponge import KECCAK_RATE_BYTES, KeccakSpongeOp, KeccakSpongeStark
from .keccak_stark import KeccakStark
from .logic import LogicStark, Operation as LogicOp
from .memory import MemoryOp, MemoryStark
from .prover import AllStark

KECCAK = 0
KECCAK_SPONGE = 1
LOGIC = 2
MEMORY = 3

# the six tables of a block proof: the first five in the reference's Table
# order (all_stark.rs:33-47), then the arithmetic table, which the CPU's
# lookups bind
CPU_TABLES = {"cpu": 0, "keccak": 1, "keccak_sponge": 2, "logic": 3,
              "memory": 4, "arithmetic": 5}
_DEFAULT_TABLES = {"keccak": KECCAK, "keccak_sponge": KECCAK_SPONGE,
                   "logic": LOGIC, "memory": MEMORY}


def ctl_keccak(t=_DEFAULT_TABLES) -> CrossTableLookup:
    """(reference all_stark.rs:108-120); ``t`` maps table names to their
    indices."""
    looking = TableWithColumns(
        table=t["keccak_sponge"], columns=sponge_mod.ctl_looking_keccak(),
        filter_column=sponge_mod.ctl_looking_keccak_filter())
    looked = TableWithColumns(table=t["keccak"],
                              columns=keccak_mod.ctl_data(),
                              filter_column=keccak_mod.ctl_filter())
    return CrossTableLookup(looking_tables=[looking], looked_table=looked)


def ctl_logic(t=_DEFAULT_TABLES) -> CrossTableLookup:
    """(reference all_stark.rs:136-154)."""
    lookers = []
    if "cpu" in t:
        lookers.append(TableWithColumns(
            table=t["cpu"], columns=cpu_mod.ctl_data_logic(),
            filter_column=cpu_mod.ctl_filter_logic()))
    lookers += [TableWithColumns(
        table=t["keccak_sponge"], columns=sponge_mod.ctl_looking_logic(i),
        filter_column=sponge_mod.ctl_looking_logic_filter())
        for i in range(sponge_mod.num_logic_ctls())]
    looked = TableWithColumns(table=t["logic"], columns=logic_mod.ctl_data(),
                              filter_column=logic_mod.ctl_filter())
    return CrossTableLookup(looking_tables=lookers, looked_table=looked)


def ctl_memory(t=_DEFAULT_TABLES) -> CrossTableLookup:
    """(reference all_stark.rs:156-177)."""
    lookers = []
    if "cpu" in t:
        lookers.append(TableWithColumns(
            table=t["cpu"], columns=cpu_mod.ctl_data_code_memory(),
            filter_column=cpu_mod.ctl_filter_code_memory()))
        lookers += [TableWithColumns(
            table=t["cpu"], columns=cpu_mod.ctl_data_gp_memory(ch),
            filter_column=cpu_mod.ctl_filter_gp_memory(ch))
            for ch in range(cpu_mod.NUM_GP_CHANNELS)]
    lookers += [TableWithColumns(
        table=t["keccak_sponge"], columns=sponge_mod.ctl_looking_memory(i),
        filter_column=sponge_mod.ctl_looking_memory_filter(i))
        for i in range(KECCAK_RATE_BYTES)]
    looked = TableWithColumns(table=t["memory"],
                              columns=memory_mod.ctl_data(),
                              filter_column=memory_mod.ctl_filter())
    return CrossTableLookup(looking_tables=lookers, looked_table=looked)


def _cpu_lookup(t, table: str, looking, looked) -> CrossTableLookup:
    """One lookup from the CPU into `table`: ``looking`` and ``looked``
    are (columns, filter) pairs of the two tables."""
    return CrossTableLookup(
        looking_tables=[TableWithColumns(table=t["cpu"], columns=looking[0],
                                         filter_column=looking[1])],
        looked_table=TableWithColumns(table=t[table], columns=looked[0],
                                      filter_column=looked[1]))


def ctl_keccak_sponge(t) -> CrossTableLookup:
    """The CPU looks up its sponge results (reference
    all_stark.rs:122-134)."""
    return _cpu_lookup(
        t, "keccak_sponge",
        (cpu_mod.ctl_data_keccak_sponge(), cpu_mod.ctl_filter_keccak_sponge()),
        (sponge_mod.ctl_looked_data(), sponge_mod.ctl_looked_filter()))


def ctl_arithmetic(t) -> CrossTableLookup:
    """The CPU's ADD/MUL/SUB/LT/GT (input0, input1, result) triples are
    looked up in the arithmetic table (no upstream analogue: the
    reference never connects this table)."""
    return _cpu_lookup(
        t, "arithmetic",
        (cpu_mod.ctl_data_arithmetic(), cpu_mod.ctl_filter_arithmetic()),
        (arith_mod.ctl_data(), arith_mod.ctl_filter()))


def ctl_arithmetic_ternary(t) -> CrossTableLookup:
    """The CPU's ADDMOD/MULMOD (a, b, m, out) quadruples, looked up in the
    arithmetic table's modular rows."""
    return _cpu_lookup(
        t, "arithmetic",
        (cpu_mod.ctl_data_arithmetic_ternary(),
         cpu_mod.ctl_filter_arithmetic_ternary()),
        (arith_mod.ctl_data_ternary(), arith_mod.ctl_filter_ternary()))


def ctl_arithmetic_div(t) -> CrossTableLookup:
    return _cpu_lookup(
        t, "arithmetic",
        (cpu_mod.ctl_data_arithmetic_div(),
         cpu_mod.ctl_filter_arithmetic_div()),
        (arith_mod.ctl_data_div(), arith_mod.ctl_filter_div()))


def ctl_arithmetic_mod(t) -> CrossTableLookup:
    return _cpu_lookup(
        t, "arithmetic",
        (cpu_mod.ctl_data_arithmetic_mod(),
         cpu_mod.ctl_filter_arithmetic_mod()),
        (arith_mod.ctl_data_mod(), arith_mod.ctl_filter_mod()))


def all_cross_table_lookups() -> List[CrossTableLookup]:
    return [ctl_keccak(), ctl_logic(), ctl_memory()]


def all_cross_table_lookups_with_cpu() -> List[CrossTableLookup]:
    t = CPU_TABLES
    return [ctl_keccak(t), ctl_keccak_sponge(t), ctl_logic(t),
            ctl_memory(t), ctl_arithmetic(t), ctl_arithmetic_ternary(t),
            ctl_arithmetic_div(t), ctl_arithmetic_mod(t)]


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


def arithmetic_range_check_policy(range_check, arith_ops) -> bool:
    """The arithmetic table's 16-bit limb range check: ``range_check``
    where it is given, else on exactly when the table reaches 2^16 rows
    (RC_MIN_ROWS), the height at which its counter column fits without
    padding.  Below that the CTL-bound limb columns are not range-checked
    (as in the reference, whose range_check_error! is a no-op,
    utils.rs:10-31)."""
    if range_check is not None:
        return bool(range_check)
    return sum(op.num_rows() for op in arith_ops) >= RC_MIN_ROWS


def make_all_stark_with_cpu(kernel, range_check: bool = False) -> AllStark:
    """The six tables of a block proof; ``range_check`` must be the flag
    the traces were made with (it changes the arithmetic table's width)."""
    return AllStark(
        starks=[CpuStark(kernel), KeccakStark(), KeccakSpongeStark(),
                LogicStark(), MemoryStark(),
                ArithmeticStark(range_check=range_check)],
        cross_table_lookups=all_cross_table_lookups_with_cpu())


def generate_all_traces_with_cpu(kernel, min_rows: int = 8,
                                 execution=None,
                                 range_check=None) -> List[np.ndarray]:
    """The six tables' traces: the CPU bootstraps the kernel into memory,
    the sponge hashes it and the CPU looks the digest up (reference
    generation/ + bootstrap_kernel.rs).  A kernel with main/halt_pc0/
    halt_pc1 labels is also executed (``execution``, else
    generation.generate_kernel_execution): its cycle rows, their memory
    ops, and their logic, arithmetic and sponge lookups enter the
    witness."""
    labels = kernel.global_labels
    if execution is not None or all(
            k in labels for k in ("main", "halt_pc0", "halt_pc1")):
        ex = execution if execution is not None else \
            generate_kernel_execution(kernel, min_rows=min_rows)
        cpu_trace, cpu_memory_ops = ex.cpu_trace, ex.memory_ops
        sponge_ops, cpu_logic_ops = ex.sponge_ops, ex.logic_ops
        cpu_arith_ops = ex.arith_ops
    else:
        cpu_trace, cpu_memory_ops, sponge_ops = \
            generate_bootstrap_kernel(kernel, min_rows=min_rows)
        cpu_logic_ops, cpu_arith_ops = [], []
    sponge_trace = KeccakSpongeStark().generate_trace(sponge_ops,
                                                      min_rows=min_rows)
    keccak_inputs, logic_ops, sponge_memory_ops = \
        _sponge_derived_witness(sponge_trace)
    keccak_trace = KeccakStark().generate_trace(keccak_inputs,
                                                min_rows=min_rows)
    logic_trace = LogicStark().generate_trace(cpu_logic_ops + logic_ops,
                                              min_rows=min_rows)
    memory_trace = MemoryStark().generate_trace(cpu_memory_ops
                                                + sponge_memory_ops)
    rc = arithmetic_range_check_policy(range_check, cpu_arith_ops)
    arith_trace = ArithmeticStark(range_check=rc).generate_trace(
        cpu_arith_ops, min_rows=min_rows)
    return [cpu_trace, keccak_trace, sponge_trace, logic_trace, memory_trace,
            arith_trace]
