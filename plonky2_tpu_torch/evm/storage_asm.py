"""SLOAD / SSTORE syscall handlers — the first contract-execution
opcodes wired through the syscall jumptable, operating on the pointered
state trie.

Reference correspondence: the reference's witness/operation.rs decodes
SLOAD/SSTORE as syscall traps (transition.rs:27-140) but ships no
handlers at this vintage (contract execution is incomplete upstream);
these handlers follow the EVM yellow-paper semantics over the in-kernel
MPT (mpt_asm.py):

  - storage slot key = keccak(32-byte big-endian slot), 64 nibbles
    (standard secure-trie addressing, same as account keys);
  - ``sys_sload``:  (kexit_info, slot, ...) -> (kexit_info, value, ...);
    value 0 for an absent slot (EVM SLOAD semantics);
  - ``sys_sstore``: (kexit_info, slot, value, ...) -> (kexit_info, ...);
    allocates a storage-schema value [x], mpt_inserts it under the slot
    key into the CURRENT account's storage subtree, and repoints the
    account's storage_ptr — so the next mpt_hash_state_trie binds the
    write into the state root.

The "current account" is the GlobalMetadata[18] VALUE POINTER
(nonce/balance/storage_ptr/code_hash quad in TrieData), set by the
caller before user code runs — the analog of the reference's
ContextMetadata::Address resolution, which needs call contexts this
framework doesn't model yet.
"""

STORAGE_ASM = """
%macro st_tdload
    // (virt) -> (TrieData[virt])
    PUSH @SEGMENT_TRIE_DATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

%macro st_tdstore
    // (virt, value) -> ()
    %stack (virt, value) -> (0, @SEGMENT_TRIE_DATA, virt, value)
    MSTORE_GENERAL
%endmacro

%macro current_account_ptr
    // () -> (vptr): GlobalMetadata[18]
    PUSH 18
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

// (slot, ret) -> (key): keccak of the 32-byte big-endian slot word, as a
// big-endian 64-nibble trie key (secure-trie storage addressing)
GLOBAL slot_to_key:
    PUSH 0
    // i, slot, ret
s2k_loop:
    DUP1
    PUSH 32
    EQ
    PUSH s2k_hash
    JUMPI
    // byte = (slot >> 8*(31-i)) & 0xff
    %stack (i, slot) -> (31, i, i, slot)
    SUB
    PUSH 8
    MUL
    DUP3
    SWAP1
    SHR
    PUSH 0xff
    AND
    // byte, i, slot, ret
    DUP2
    %stack (i, byte) -> (0, @SEGMENT_KERNEL_GENERAL, i, byte)
    MSTORE_GENERAL
    PUSH 1
    ADD
    PUSH s2k_loop
    JUMP
s2k_hash:
    POP
    POP
    PUSH 32
    PUSH 0
    PUSH @SEGMENT_KERNEL_GENERAL
    PUSH 0
    KECCAK_GENERAL
    // digest (LE-packed), ret
    %stack (d) -> (d, s2k_swapped)
    PUSH u256_byteswap
    JUMP
s2k_swapped:
    SWAP1
    JUMP

// syscall handler: (kexit_info, slot, ...) -> (kexit_info, value, ...)
GLOBAL sys_sload:
    SWAP1
    // slot, kexit, ...
    %stack (slot) -> (slot, sload_key)
    PUSH slot_to_key
    JUMP
sload_key:
    // key, kexit, ...
    %current_account_ptr
    PUSH 2
    ADD
    %st_tdload
    // sptr, key, kexit, ...
    %stack (sptr, key) -> (sptr, 64, key, sload_found)
    PUSH mpt_read
    JUMP
sload_found:
    // vptr, kexit, ...
    DUP1
    ISZERO
    PUSH sload_absent
    JUMPI
    %st_tdload
    // value, kexit, ...
sload_absent:
    // value-or-0, kexit, ...
    SWAP1
    EXIT_KERNEL

// syscall handler: (kexit_info, slot, value, ...) -> (kexit_info, ...)
GLOBAL sys_sstore:
    SWAP1
    %stack (slot) -> (slot, sstore_key)
    PUSH slot_to_key
    JUMP
sstore_key:
    // key, kexit, value, ...
    %stack (key, kexit, value) -> (1, sstore_alloc, key, kexit, value)
    PUSH mpt_alloc
    JUMP
sstore_alloc:
    // nv, key, kexit, value, ...
    DUP1
    DUP5
    SWAP1
    %st_tdstore
    // TD[nv] = value; nv, key, kexit, value, ...
    %current_account_ptr
    PUSH 2
    ADD
    %st_tdload
    // sptr, nv, key, kexit, value, ...
    %stack (sptr, nv, key, kexit, value) ->
        (sptr, 64, key, nv, sstore_inserted, kexit)
    PUSH mpt_insert
    JUMP
sstore_inserted:
    // new_sroot, kexit, ...
    %current_account_ptr
    PUSH 2
    ADD
    %st_tdstore
    // TD[vptr+2] = new storage root; kexit, ...
    EXIT_KERNEL
"""
