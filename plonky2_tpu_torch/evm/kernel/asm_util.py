"""The port's copy of plonky2_tpu/evm/kernel/asm_util.py.

Shared kernel-asm byte/RLP utilities used by the secp256k1 routines
(evm/secp_asm.py) and the in-kernel trie hasher (evm/mpt_asm.py).

Reference correspondence: the reference's util asm (rlp/encode.asm,
util/*.asm — sources absent from its tree; behavior spec'd by
cpu/kernel/tests/rlp/ and tests/packing.rs).  All routines deliberately
avoid the unconstrained BYTE opcode and SHL/SHR (which would need the
shift table); byte extraction runs through DIV/MOD, which are bound to the
arithmetic table by the div/mod cross-table lookups (all_stark.py
ctl_arithmetic_div/_mod).

Stack convention: `routine(args..., retaddr)`, leftmost item = top of
stack; routines exit by rearranging to (ret, outs...) and JUMPing.
"""

UTIL_ASM = """
// ---------------------------------------------------------------------------
// byte packing helpers
// ---------------------------------------------------------------------------

// (seg, val, off, n, ret) -> (): write the n low bytes of val big-endian
// at context-0 (seg)[off .. off+n)
GLOBAL store_be:
sbe_loop:
    // stack: seg, val, off, n, ret
    DUP4
    ISZERO
    PUSH sbe_done
    JUMPI
    // b = val mod 256
    DUP2
    %stack (v) -> (v, 256)
    MOD
    // b, seg, val, off, n
    // addr = off + n - 1
    DUP5
    DUP5
    ADD
    %stack (offn) -> (offn, 1)
    SUB
    // addr, b, seg, val, off, n
    DUP3
    %stack (seg, addr, b) -> (0, seg, addr, b)
    MSTORE_GENERAL
    // seg, val, off, n
    // val //= 256
    SWAP1
    %stack (v) -> (v, 256)
    DIV
    SWAP1
    // n -= 1
    SWAP3
    %stack (n) -> (n, 1)
    SUB
    SWAP3
    PUSH sbe_loop
    JUMP
sbe_done:
    %stack (seg, val, off, n, ret) -> (ret)
    JUMP

// (seg, off, n, ret) -> (val): read n bytes big-endian from (seg)[off..)
GLOBAL load_be:
    PUSH 0
    // acc, seg, off, n, ret
lbe_loop:
    DUP4
    ISZERO
    PUSH lbe_done
    JUMPI
    // acc = acc*256 + mem[off]
    DUP3
    DUP3
    %stack (seg, off) -> (0, seg, off)
    MLOAD_GENERAL
    // b, acc, seg, off, n
    SWAP1
    %stack (acc) -> (256, acc)
    MUL
    ADD
    // acc', seg, off, n
    // off += 1; n -= 1
    SWAP2
    %stack (off) -> (1, off)
    ADD
    SWAP2
    SWAP3
    %stack (n) -> (n, 1)
    SUB
    SWAP3
    PUSH lbe_loop
    JUMP
lbe_done:
    %stack (acc, seg, off, n, ret) -> (ret, acc)
    JUMP

// (dseg, dst, sseg, src, n, ret) -> (): byte copy between segments
GLOBAL mem_copy:
mcp_loop:
    DUP5
    ISZERO
    PUSH mcp_done
    JUMPI
    // b = (sseg)[src]
    DUP4
    DUP4
    %stack (sseg, src) -> (0, sseg, src)
    MLOAD_GENERAL
    // b, dseg, dst, sseg, src, n, ret
    DUP3
    DUP3
    %stack (dseg, dst, b) -> (0, dseg, dst, b)
    MSTORE_GENERAL
    // dseg, dst, sseg, src, n, ret
    SWAP1
    %stack (dst) -> (dst, 1)
    ADD
    SWAP1
    SWAP3
    %stack (src) -> (src, 1)
    ADD
    SWAP3
    SWAP4
    %stack (n) -> (n, 1)
    SUB
    SWAP4
    PUSH mcp_loop
    JUMP
mcp_done:
    %stack (dseg, dst, sseg, src, n, ret) -> (ret)
    JUMP

// (seg, pos, len, ret) -> (pos'): forward RLP STRING header for a payload
// of `len` bytes about to be written at pos'.  Callers wrap payloads that
// are themselves complete RLP items (a scalar's RLP, an account list), so
// a 1-byte payload is necessarily < 0x80 and embeds verbatim, headerless
// (yellow paper B.1 first case).
GLOBAL rlp_write_str_prefix_fwd:
    DUP3
    PUSH 1
    EQ
    PUSH rwsp_verbatim
    JUMPI
    DUP3
    PUSH 56
    GT
    PUSH rwsp_short
    JUMPI
    // long form: 0xb7+lenlen, then BE length bytes
    DUP3
    %stack (l) -> (l, rwsp_len)
    PUSH u256_bytelen
    JUMP
rwsp_len:
    // lenlen, seg, pos, len, ret
    DUP1
    %stack (ll) -> (ll, 0xb7)
    ADD
    // hdr, lenlen, seg, pos, len, ret
    DUP4
    DUP4
    %stack (seg, pos, hdr) -> (0, seg, pos, hdr)
    MSTORE_GENERAL
    // lenlen, seg, pos, len, ret
    %stack (lenlen, seg, pos, len) -> (pos, 1, seg, len, lenlen, lenlen, pos)
    ADD
    // pos+1, seg, len, lenlen, lenlen, pos, ret
    %stack (pos1, seg, len, lenlen) -> (seg, len, pos1, lenlen, rwsp_done)
    PUSH store_be
    JUMP
rwsp_done:
    // lenlen, pos, ret
    ADD
    %stack (x) -> (x, 1)
    ADD
    %stack (p, ret) -> (ret, p)
    JUMP
rwsp_short:
    // seg, pos, len, ret
    DUP3
    %stack (l) -> (l, 0x80)
    ADD
    DUP3
    DUP3
    %stack (seg, pos, hdr) -> (0, seg, pos, hdr)
    MSTORE_GENERAL
    // seg, pos, len, ret
    SWAP1
    %stack (pos) -> (pos, 1)
    ADD
    %stack (pos1, seg, len, ret) -> (ret, pos1)
    JUMP
rwsp_verbatim:
    %stack (seg, pos, len, ret) -> (ret, pos)
    JUMP

// (v, ret) -> (blen): number of significant bytes of v (0 for v == 0)
GLOBAL u256_bytelen:
    PUSH 0
    // blen, v, ret
ubl_loop:
    DUP2
    ISZERO
    PUSH ubl_done
    JUMPI
    %stack (blen) -> (1, blen)
    ADD
    SWAP1
    %stack (v) -> (v, 256)
    DIV
    SWAP1
    PUSH ubl_loop
    JUMP
ubl_done:
    %stack (blen, v, ret) -> (ret, blen)
    JUMP

// (x, ret) -> (rev): byte-reversed u256.  KECCAK_GENERAL pushes digests in
// the sponge's little-endian packing; trie roots / addresses compare as
// big-endian integers, so digests pass through here.
GLOBAL u256_byteswap:
    %stack (x) -> (x, 0, 32)
    // x, acc, cnt, ret
ubs_loop:
    DUP3
    ISZERO
    PUSH ubs_done
    JUMPI
    DUP1
    %stack (v) -> (v, 256)
    MOD
    // b, x, acc, cnt
    DUP3
    %stack (acc) -> (256, acc)
    MUL
    ADD
    // acc' = acc*256 + b, x, acc, cnt
    SWAP2
    POP
    // x, acc', cnt
    %stack (x) -> (x, 256)
    DIV
    SWAP2
    %stack (cnt) -> (cnt, 1)
    SUB
    SWAP2
    PUSH ubs_loop
    JUMP
ubs_done:
    %stack (x, acc, cnt, ret) -> (ret, acc)
    JUMP

// ---------------------------------------------------------------------------
// RLP writers (yellow paper appendix B); spec'd by the reference's
// cpu/kernel/tests/rlp/encode.rs cases
// ---------------------------------------------------------------------------

// (seg, pos, v, ret) -> (pos'): append the canonical RLP of scalar v
GLOBAL rlp_write_scalar:
    DUP3
    ISZERO
    PUSH rws_zero
    JUMPI
    DUP3
    PUSH 0x80
    GT
    // 0x80 > v: single byte literal
    PUSH rws_single
    JUMPI
    // multi-byte: blen = bytelen(v); header 0x80+blen; then BE bytes
    DUP3
    %stack (v) -> (v, rws_len)
    PUSH u256_bytelen
    JUMP
rws_len:
    // blen, seg, pos, v, ret
    DUP1
    %stack (blen) -> (blen, 0x80)
    ADD
    // hdr, blen, seg, pos, v, ret
    DUP4
    DUP4
    %stack (seg, pos, hdr) -> (0, seg, pos, hdr)
    MSTORE_GENERAL
    // blen, seg, pos, v, ret
    // store_be(seg, v, pos+1, blen) -> pos' = pos+1+blen
    SWAP2
    %stack (pos) -> (pos, 1)
    ADD
    SWAP2
    // blen, seg, pos+1, v, ret
    %stack (blen, seg, pos1, v) -> (seg, v, pos1, blen, rws_stored, pos1, blen)
    PUSH store_be
    JUMP
rws_stored:
    // pos1, blen, ret
    ADD
    %stack (pos2, ret) -> (ret, pos2)
    JUMP
rws_zero:
    %stack (seg, pos, v) -> (0, seg, pos, 0x80, pos)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
    %stack (pos1, ret) -> (ret, pos1)
    JUMP
rws_single:
    %stack (seg, pos, v) -> (0, seg, pos, v, pos)
    MSTORE_GENERAL
    %stack (pos) -> (pos, 1)
    ADD
    %stack (pos1, ret) -> (ret, pos1)
    JUMP

// (seg, pos, payload_len, ret) -> (hstart): write an RLP LIST header for a
// payload already sitting at (seg)[pos ..pos+payload_len) so the header
// ends exactly at pos; returns the header start.  0xc0+L short form for
// L <= 55, else 0xf7+lenlen / BE length bytes.
GLOBAL rlp_write_list_prefix:
    DUP3
    PUSH 56
    GT
    // 56 > L: short form
    PUSH rwlp_short
    JUMPI
    // long form: lenlen = bytelen(L)
    DUP3
    %stack (l) -> (l, rwlp_len)
    PUSH u256_bytelen
    JUMP
rwlp_len:
    // lenlen, seg, pos, L, ret
    // hstart = pos - 1 - lenlen
    DUP3
    DUP2
    SWAP1
    SUB
    %stack (t) -> (t, 1)
    SUB
    // hstart, lenlen, seg, pos, L, ret
    // write 0xf7+lenlen at hstart
    DUP2
    %stack (lenlen) -> (lenlen, 0xf7)
    ADD
    DUP2
    DUP5
    %stack (seg, hstart, hdr) -> (0, seg, hstart, hdr)
    MSTORE_GENERAL
    // hstart, lenlen, seg, pos, L, ret
    // store_be(seg, L, hstart+1, lenlen)
    %stack (hstart, lenlen, seg, pos, L) -> (hstart, 1, seg, L, lenlen, hstart)
    ADD
    // hstart+1, seg, L, lenlen, hstart, ret
    %stack (hs1, seg, L, lenlen) -> (seg, L, hs1, lenlen, rwlp_stored)
    PUSH store_be
    JUMP
rwlp_stored:
    // hstart, ret
    %stack (hstart, ret) -> (ret, hstart)
    JUMP
rwlp_short:
    // seg, pos, L, ret
    // hstart = pos - 1; header = 0xc0 + L
    SWAP1
    %stack (pos) -> (pos, 1)
    SUB
    SWAP1
    // seg, hstart, L, ret
    DUP3
    %stack (l) -> (l, 0xc0)
    ADD
    // hdr, seg, hstart, L, ret
    DUP3
    DUP3
    %stack (seg, hstart, hdr) -> (0, seg, hstart, hdr)
    MSTORE_GENERAL
    %stack (seg, hstart, L, ret) -> (ret, hstart)
    JUMP
"""
