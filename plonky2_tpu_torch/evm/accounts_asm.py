"""In-kernel account routines: ``balance``, ``extcodesize``,
``extcodecopy`` and the shared proof-bound code loader.

Reference correspondence (asm sources absent from the reference tree;
behavior spec'd by its interpreter tests):

  - ``balance``      — core/balance.asm, spec
      cpu/kernel/tests/balance.rs: (address, retdest) -> (balance), 0 for
      an absent account (EVM BALANCE semantics).  Resolves through
      mpt_read on the pointered state trie, so the returned balance is
      the proof-bound account value.
  - ``extcodesize``  — core/account_code.asm, spec
      tests/account_code.rs::test_extcodesize: (address, retdest) ->
      (len).
  - ``extcodecopy``  — same file, ::test_extcodecopy:
      (address, dest_offset, offset, size, retdest) -> (); copies
      code[offset .. offset+size) into MainMemory[dest_offset ..],
      zero-padding past the code end (EVM EXTCODECOPY semantics).
  - ``load_code``    — (code_hash, retdest) -> (len): streams the code
      bytes from PROVER_INPUT(account_code::{length,get}) into
      Segment::KernelAccountCode, then KECCAKs the loaded bytes through
      KECCAK_GENERAL and PANICs unless the digest equals ``code_hash`` —
      the prover cannot lie about either the bytes or the length
      (reference generation/prover_input.rs account_code handling).

Stack convention: routine(args..., retdest) with args above the return
address, results returned via (retdest, outs...) + JUMP.
"""

ACCOUNTS_ASM = """
%macro acc_tdload
    // (virt) -> (TrieData[virt])
    PUSH @SEGMENT_TRIE_DATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

%macro acc_state_root
    // () -> (state_root_ptr)
    PUSH 4
    PUSH @SEGMENT_GLOBAL_METADATA
    PUSH 0
    MLOAD_GENERAL
%endmacro

// (address, ret) -> (balance): 0 for an absent account
GLOBAL balance:
    %stack (addr) -> (addr, bal_key)
    PUSH addr_to_key
    JUMP
bal_key:
    // key, ret
    %acc_state_root
    %stack (root, key) -> (root, 64, key, bal_found)
    PUSH mpt_read
    JUMP
bal_found:
    // vptr, ret
    DUP1
    ISZERO
    PUSH bal_absent
    JUMPI
    PUSH 1
    ADD
    %acc_tdload
    // balance, ret
bal_absent:
    // balance-or-0, ret
    SWAP1
    JUMP

// (code_hash, ret) -> (len): load the full contract code into
// Segment::KernelAccountCode[0..len) and PANIC unless keccak(code) ==
// code_hash.  PROVER_INPUT(account_code::length) reads the hash from the
// top of stack; (account_code::get) reads the hash 3rd-from-top and the
// byte index from the top.
GLOBAL load_code:
    PROVER_INPUT(account_code::length)
    // len, ch, ret
    PUSH 0
    // i, len, ch, ret
lc_loop:
    DUP2
    DUP2
    EQ
    PUSH lc_done
    JUMPI
    PROVER_INPUT(account_code::get)
    // byte, i, len, ch, ret
    DUP2
    %stack (i, byte) -> (0, @SEGMENT_KERNEL_ACCOUNT_CODE, i, byte)
    MSTORE_GENERAL
    // i, len, ch, ret
    PUSH 1
    ADD
    PUSH lc_loop
    JUMP
lc_done:
    // i(=len), len, ch, ret
    POP
    // len, ch, ret
    DUP1
    %stack (len) -> (0, @SEGMENT_KERNEL_ACCOUNT_CODE, 0, len)
    KECCAK_GENERAL
    // digest (LE-packed), len, ch, ret
    %stack (d) -> (d, lc_swapped)
    PUSH u256_byteswap
    JUMP
lc_swapped:
    // digest, len, ch, ret
    DUP3
    EQ
    ISZERO
    PUSH lc_panic
    JUMPI
    // len, ch, ret
    %stack (len, ch, ret) -> (ret, len)
    JUMP
lc_panic:
    PANIC

// (address, ret) -> (code_hash): the account's code hash; PANICs for an
// absent account (callers guard with balance-style existence checks)
GLOBAL account_code_hash:
    %stack (addr) -> (addr, ach_key)
    PUSH addr_to_key
    JUMP
ach_key:
    %acc_state_root
    %stack (root, key) -> (root, 64, key, ach_found)
    PUSH mpt_read
    JUMP
ach_found:
    // vptr, ret
    DUP1
    ISZERO
    PUSH ach_panic
    JUMPI
    PUSH 3
    ADD
    %acc_tdload
    SWAP1
    JUMP
ach_panic:
    PANIC

// (address, ret) -> (len)
GLOBAL extcodesize:
    %stack (addr) -> (addr, ecs_ch)
    PUSH account_code_hash
    JUMP
ecs_ch:
    // code_hash, ret — tail-call load_code
    PUSH load_code
    JUMP

// (address, dest_offset, offset, size, ret) -> ()
GLOBAL extcodecopy:
    %stack (addr) -> (addr, ecc_ch)
    PUSH account_code_hash
    JUMP
ecc_ch:
    // code_hash, dest_offset, offset, size, ret
    %stack (ch) -> (ch, ecc_loaded)
    PUSH load_code
    JUMP
ecc_loaded:
    // len, dest_offset, offset, size, ret
    PUSH 0
    // i, len, dest_offset, offset, size, ret
ecc_loop:
    DUP5
    DUP2
    EQ
    PUSH ecc_done
    JUMPI
    // b = (offset + i < len) ? KAC[offset + i] : 0
    DUP4
    DUP2
    ADD
    // src = offset + i, i, len, dest_offset, offset, size, ret
    DUP3
    DUP2
    LT
    // src < len ?, src, i, len, dest_offset, offset, size, ret
    PUSH ecc_inrange
    JUMPI
    POP
    PUSH 0
    PUSH ecc_store
    JUMP
ecc_inrange:
    // src, i, len, dest_offset, offset, size, ret
    PUSH @SEGMENT_KERNEL_ACCOUNT_CODE
    PUSH 0
    MLOAD_GENERAL
    // b, i, len, dest_offset, offset, size, ret
ecc_store:
    // b, i, len, dest_offset, offset, size, ret
    DUP4
    DUP3
    ADD
    // dst = dest_offset + i, b, i, len, dest_offset, offset, size, ret
    %stack (dst, b) -> (0, @SEGMENT_MAIN_MEMORY, dst, b)
    MSTORE_GENERAL
    // i, len, dest_offset, offset, size, ret
    PUSH 1
    ADD
    PUSH ecc_loop
    JUMP
ecc_done:
    // i, len, dest_offset, offset, size, ret
    %stack (i, len, dest_offset, offset, size, ret) -> (ret)
    JUMP
"""
