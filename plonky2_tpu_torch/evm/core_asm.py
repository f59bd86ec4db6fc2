"""Core kernel routines: jumpdest analysis and contract-address derivation.

Reference correspondence: jumpdest_analysis.asm / create_addresses.asm
(sources absent from the reference tree; interfaces spec'd by
cpu/kernel/tests/core/jumpdest_analysis.rs and create_addresses.rs — the
reference's own create-address tests still assert placeholder values,
`expected_addr = 123` with a "TODO: Replace with real data"; here the
routines implement the real yellow-paper / EIP-1014 semantics and the
tests check genuine Ethereum vectors).

- jumpdest_analysis(ctx, code_len, retdest): walk (ctx, Code)[0..len),
  set JumpdestBits[ctx][i] = 1 for every JUMPDEST byte that is not PUSH
  data (the bits the JUMP/JUMPI constraints read in user mode).
- get_create_address(sender, nonce, retdest) -> addr:
  keccak(rlp([sender, nonce]))[12:].
- get_create2_address(sender, salt, code_ctx, code_seg, code_off,
  code_len, retdest) -> addr: keccak(0xff ++ sender ++ salt ++
  keccak(code))[12:]  (EIP-1014).

Scratch: KernelGeneral2 at offset 109+ (the pubkey buffer uses [0, 64)).
"""

CORE_ASM = """
// (ctx, code_len, ret) -> ()
GLOBAL jumpdest_analysis:
    PUSH 0
    // i, ctx, len, ret
jda_loop:
    DUP3
    DUP2
    LT
    ISZERO
    PUSH jda_done
    JUMPI
    // opcode = Code[ctx][i]
    DUP1
    PUSH @SEGMENT_CODE
    DUP4
    MLOAD_GENERAL
    // op, i, ctx, len, ret
    DUP1
    PUSH 0x5b
    EQ
    PUSH jda_mark
    JUMPI
    // PUSH1..PUSH32 skip their immediate bytes: i += op - 0x5f
    DUP1
    PUSH 0x5f
    LT
    DUP2
    PUSH 0x80
    GT
    MUL
    PUSH jda_push
    JUMPI
    POP
    %stack (i) -> (i, 1)
    ADD
    PUSH jda_loop
    JUMP
jda_push:
    // op, i, ctx, len, ret: PUSHk at i consumes k = op - 0x5f immediate
    // bytes, so the next opcode sits at i + 1 + k = i + op - 0x5e
    %stack (op) -> (op, 0x5e)
    SUB
    ADD
    PUSH jda_loop
    JUMP
jda_mark:
    // op, i, ctx, len, ret
    POP
    DUP2
    %stack (ctx, i) -> (ctx, @SEGMENT_JUMPDEST_BITS, i, 1, i)
    MSTORE_GENERAL
    // i, ctx, len, ret
    %stack (i) -> (i, 1)
    ADD
    PUSH jda_loop
    JUMP
jda_done:
    %stack (i, ctx, len, ret) -> (ret)
    JUMP

// (a, b, ret) -> (a^b mod 2^256): square-and-multiply; the EXP syscall's
// kernel routine (spec: cpu/kernel/tests/exp.rs — must agree with the
// EVM opcode semantics for all operands incl. 0^0 = 1)
GLOBAL exp:
    %stack (a, b) -> (b, a, 1)
    // b, base, acc, ret
exp_loop:
    DUP1
    ISZERO
    PUSH exp_done
    JUMPI
    DUP1
    PUSH 1
    AND
    ISZERO
    PUSH exp_skip
    JUMPI
    // acc *= base
    DUP2
    DUP4
    MUL
    SWAP3
    POP
exp_skip:
    // b, base, acc, ret
    SWAP1
    DUP1
    MUL
    SWAP1
    // b, base², acc, ret
    %stack (b) -> (b, 2)
    DIV
    PUSH exp_loop
    JUMP
exp_done:
    %stack (b, base, acc, ret) -> (ret, acc)
    JUMP

// (ctx, seg, off, len, ret) -> (value): pack len big-endian bytes from
// (ctx, seg)[off..off+len) into one word (spec: tests/packing.rs)
GLOBAL mload_packing:
    PUSH 0
    // acc, ctx, seg, off, len, ret
mlp_loop:
    DUP5
    ISZERO
    PUSH mlp_done
    JUMPI
    DUP4
    DUP4
    DUP4
    MLOAD_GENERAL
    // b, acc, ctx, seg, off, len, ret
    SWAP1
    %stack (acc) -> (256, acc)
    MUL
    ADD
    // acc', ctx, seg, off, len, ret
    SWAP3
    %stack (off) -> (off, 1)
    ADD
    SWAP3
    SWAP4
    %stack (len) -> (len, 1)
    SUB
    SWAP4
    PUSH mlp_loop
    JUMP
mlp_done:
    %stack (acc, ctx, seg, off, len, ret) -> (ret, acc)
    JUMP

// (sender, nonce, ret) -> (addr): keccak(rlp([sender, nonce]))[12:]
GLOBAL get_create_address:
    // payload builds at KernelGeneral2[109..): 0x94 + 20 sender bytes,
    // then the nonce scalar; list header ends at 109
    PUSH 109
    DUP1
    %stack (pos) -> (0, @SEGMENT_KERNEL_GENERAL_2, pos, 0x94)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
    // pos(110), sender, nonce, ret
    %stack (pos, sender) -> (@SEGMENT_KERNEL_GENERAL_2, sender, pos, 20, gca_s, pos)
    PUSH store_be
    JUMP
gca_s:
    // pos(110), nonce, ret
    %stack (pos) -> (pos, 20)
    ADD
    %stack (pos, nonce) -> (@SEGMENT_KERNEL_GENERAL_2, pos, nonce, gca_n)
    PUSH rlp_write_scalar
    JUMP
gca_n:
    // pe, ret
    DUP1
    %stack (pe) -> (pe, 109)
    SUB
    // L, pe, ret
    %stack (l) -> (@SEGMENT_KERNEL_GENERAL_2, 109, l, gca_p)
    PUSH rlp_write_list_prefix
    JUMP
gca_p:
    // hstart, pe, ret
    DUP2
    DUP2
    SWAP1
    SUB
    // total, hstart, pe, ret
    %stack (total, hstart, pe) -> (0, @SEGMENT_KERNEL_GENERAL_2, hstart, total)
    KECCAK_GENERAL
    %stack (d) -> (d, gca_sw)
    PUSH u256_byteswap
    JUMP
gca_sw:
    %stack (d) -> (d, @U160)
    MOD
    %stack (a, ret) -> (ret, a)
    JUMP

// (sender, salt, code_ctx, code_seg, code_off, code_len, ret) -> (addr):
// EIP-1014: keccak(0xff ++ sender ++ salt ++ keccak(init_code))[12:]
GLOBAL get_create2_address:
    %stack (sender, salt, ctx, seg, off, len) -> (ctx, seg, off, len, sender, salt)
    KECCAK_GENERAL
    // code-hash (LE-packed), sender, salt, ret
    %stack (d) -> (d, gc2_sw)
    PUSH u256_byteswap
    JUMP
gc2_sw:
    // ch, sender, salt, ret
    %stack () -> (0, @SEGMENT_KERNEL_GENERAL_2, 109, 0xff)
    MSTORE_GENERAL
    %stack (ch, sender) -> (@SEGMENT_KERNEL_GENERAL_2, sender, 110, 20, gc2_s, ch)
    PUSH store_be
    JUMP
gc2_s:
    // ch, salt, ret
    %stack (ch, salt) -> (@SEGMENT_KERNEL_GENERAL_2, salt, 130, 32, gc2_salt, ch)
    PUSH store_be
    JUMP
gc2_salt:
    // ch, ret
    %stack (ch) -> (@SEGMENT_KERNEL_GENERAL_2, ch, 162, 32, gc2_ch)
    PUSH store_be
    JUMP
gc2_ch:
    %stack () -> (0, @SEGMENT_KERNEL_GENERAL_2, 109, 85)
    KECCAK_GENERAL
    %stack (d) -> (d, gc2_sw2)
    PUSH u256_byteswap
    JUMP
gc2_sw2:
    %stack (d) -> (d, @U160)
    MOD
    %stack (a, ret) -> (ret, a)
    JUMP
"""
