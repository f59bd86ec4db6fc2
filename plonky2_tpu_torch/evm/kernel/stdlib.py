"""The port's copy of plonky2_tpu/evm/kernel/stdlib.py.

Reusable kernel assembly routines (the seed of the reference's ~40-file
asm standard library, cpu/kernel/aggregator.rs — whose sources are absent
from its own tree; these are original routines in the same DSL).
"""

# Fills Segment::ShiftTable with 2^i at offset i for i in 0..255, as the
# reference's kernel does at startup so SHL/SHR rows can read 2^disp
# through their dedicated memory channel (cpu/shift.rs:11-60).  Call with
# an empty stack; ~2.8k cycles.
SHIFT_TABLE_INIT = """
GLOBAL init_shift_table:
    PUSH 1
    PUSH 0
    // stack: i, v
shift_table_loop:
    DUP2
    DUP2
    // stack: i, v, i, v
    PUSH @SEGMENT_SHIFT_TABLE
    PUSH 0
    MSTORE_GENERAL
    // stack: i, v
    SWAP1
    DUP1
    ADD
    SWAP1
    // stack: i, 2v
    PUSH 1
    ADD
    // stack: i+1, 2v
    DUP1
    PUSH 256
    EQ
    ISZERO
    // stack: i+1 != 256, i+1, 2v
    PUSH shift_table_loop
    JUMPI
    // stack: 256, 2^256 (mod 2^256 = 0)
    POP
    POP
"""
