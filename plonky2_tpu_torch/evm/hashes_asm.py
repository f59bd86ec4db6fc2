"""Precompile hash routines as kernel asm: ``sha2`` (SHA-256),
``ripemd`` (RIPEMD-160) and ``blake2b`` (BLAKE2b-512, unkeyed).

Reference correspondence: core/hash.asm / ripemd.asm / blake2b.asm
(sources absent from the reference tree); behavior spec'd by
cpu/kernel/tests/hash.rs and ripemd.rs — input arrives ON THE STACK as
(len, byte0, ..., byte_{len-1}, retdest) with ``len`` on top and byte0
right under it; the result is returned on the stack (one word for the
256/160-bit digests, (hi, lo) for blake2b's 512 bits).

The asm is GENERATED by python helpers below: every rotation/shift is by
a compile-time constant, emitted as DIV/MUL/MOD by powers of two (no
shift table dependency), and the round loops run over constant tables
materialized into Segment::KernelGeneral2 by unrolled stores.

Scratch map (Segment::KernelGeneral2):
  [0,      17000)  message bytes + padding (inputs <= 10000 bytes/spec)
  [20000,  20064)  SHA-256 K table
  [20100,  20108)  SHA-256 H state
  [20200,  20264)  SHA-256 W schedule
  [20300,  20312)  scalar locals (len, blocks, blk, t, T1, T2 ...)
  [21000,  21080)  RIPEMD tables r / r' (80 + 80)
  [21200,  21360)  RIPEMD tables s / s'
  [21400,  21412)  RIPEMD state + locals
  [21500,  21516)  RIPEMD X[0..16) of the current block
  [22000,  22192)  BLAKE2b sigma table (12 rounds x 16)
  [22200,  22216)  BLAKE2b v[0..16)
  [22300,  22308)  BLAKE2b h[0..8)
  [22400,  22416)  BLAKE2b m[0..16) of the current block
  [22500,  22510)  BLAKE2b locals
"""

_SEG = "@SEGMENT_KERNEL_GENERAL_2"

_K256 = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
_H256 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
         0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19]

K_BASE, H_BASE, W_BASE, L_BASE = 20000, 20100, 20200, 20300
# local slots
L_LEN, L_NBLK, L_BLK, L_T, L_T1, L_T2, L_TMP = range(L_BASE, L_BASE + 7)
A_BASE = 20320                     # a..h working state


def _store(slot: int) -> str:
    """(v) -> (); mem[slot] = v"""
    return f"""
    %stack (v) -> (0, {_SEG}, {slot}, v)
    MSTORE_GENERAL
"""


def _load(slot: int) -> str:
    """() -> (mem[slot])"""
    return f"""
    PUSH {slot}
    PUSH {_SEG}
    PUSH 0
    MLOAD_GENERAL
"""


def _store_at_top() -> str:
    """(addr, v) -> (); mem[addr] = v   (addr on top)"""
    return f"""
    %stack (addr, v) -> (0, {_SEG}, addr, v)
    MSTORE_GENERAL
"""


def _load_at_top() -> str:
    """(addr) -> (mem[addr])"""
    return f"""
    PUSH {_SEG}
    PUSH 0
    MLOAD_GENERAL
"""


def _rotr32(n: int) -> str:
    """(x) -> (rotr32(x, n)) for 32-bit x"""
    return f"""
    DUP1
    PUSH {1 << n}
    SWAP1
    DIV
    SWAP1
    PUSH {1 << n}
    SWAP1
    MOD
    PUSH {1 << (32 - n)}
    MUL
    ADD
"""


def _shr(n: int) -> str:
    """(x) -> (x >> n)"""
    return f"""
    PUSH {1 << n}
    SWAP1
    DIV
"""


def _mod32() -> str:
    return """
    PUSH 0x100000000
    SWAP1
    MOD
"""


def _table_init(base: int, values) -> str:
    """Unrolled constant-table materialization."""
    out = []
    for i, v in enumerate(values):
        out.append(f"""
    PUSH {v}
    PUSH {base + i}
    PUSH {_SEG}
    PUSH 0
    MSTORE_GENERAL
""")
    return "".join(out)


def _big_sigma(n1: int, n2: int, n3: int) -> str:
    """(x) -> (rotr n1 ^ rotr n2 ^ rotr n3)"""
    return f"""
    DUP1
    DUP1
{_rotr32(n1)}
    SWAP1
{_rotr32(n2)}
    XOR
    SWAP1
{_rotr32(n3)}
    XOR
"""


def _small_sigma(n1: int, n2: int, n3: int) -> str:
    """(x) -> (rotr n1 ^ rotr n2 ^ shr n3)"""
    return f"""
    DUP1
    DUP1
{_rotr32(n1)}
    SWAP1
{_rotr32(n2)}
    XOR
    SWAP1
{_shr(n3)}
    XOR
"""


def _sha2_asm() -> str:
    # --- stack -> memory copy + padding + block count ---
    head = f"""
// (len, byte0, ..., retdest) -> (sha256 digest)
GLOBAL sha2:
    DUP1
{_store(L_LEN)}
    // copy the message bytes from the stack into scratch [0, len)
    PUSH 0
    // i, len, b0, b1, ..., ret
sha2_copy:
    DUP2
    DUP2
    EQ
    PUSH sha2_copied
    JUMPI
    %stack (i, len, b) -> (0, {_SEG}, i, b, i, len)
    MSTORE_GENERAL
    PUSH 1
    ADD
    PUSH sha2_copy
    JUMP
sha2_copied:
    POP
    POP
    // ret
    // padding: mem[len] = 0x80; zero up to padlen-8; 8-byte BE bitlength
    // padded length P = ((len + 8) // 64 + 1) * 64
{_load(L_LEN)}
    PUSH 0x80
    DUP2
    %stack (addr, v, len) -> (0, {_SEG}, addr, v, len)
    MSTORE_GENERAL
    // len, ret
    DUP1
    PUSH 8
    ADD
    PUSH 64
    SWAP1
    DIV
    PUSH 1
    ADD
    PUSH 64
    MUL
    // P, len, ret
    DUP1
    PUSH 64
    SWAP1
    DIV
{_store(L_NBLK)}
    // P, len, ret — zero (len+1 .. P-8)
    SWAP1
    PUSH 1
    ADD
    // z = len+1, P, ret
sha2_zero:
    DUP2
    PUSH 8
    SWAP1
    SUB
    DUP2
    EQ
    PUSH sha2_zeroed
    JUMPI
    DUP1
    %stack (addr) -> (0, {_SEG}, addr, 0)
    MSTORE_GENERAL
    PUSH 1
    ADD
    PUSH sha2_zero
    JUMP
sha2_zeroed:
    // z(=P-8), P, ret — write the 8-byte big-endian bit length
{_load(L_LEN)}
    PUSH 8
    MUL
    // bits, z, P, ret
    %stack (bits, z) -> ({_SEG}, bits, z, 8, sha2_lenw, z)
    PUSH store_be
    JUMP
sha2_lenw:
    // z, P, ret
    POP
    POP
    // ret
"""
    # --- init H + K tables ---
    init = _table_init(K_BASE, _K256) + _table_init(H_BASE, _H256)

    # --- per-block processing ---
    # W[0..16): 4-byte BE loads from the message
    block_loop = f"""
    PUSH 0
{_store(L_BLK)}
sha2_blk_loop:
{_load(L_BLK)}
{_load(L_NBLK)}
    EQ
    PUSH sha2_finish
    JUMPI
    // W[0..16) = big-endian words of block
    PUSH 0
{_store(L_T)}
sha2_w16:
{_load(L_T)}
    PUSH 16
    SWAP1
    LT
    ISZERO
    PUSH sha2_w64
    JUMPI
    // off = blk*64 + t*4
{_load(L_BLK)}
    PUSH 64
    MUL
{_load(L_T)}
    PUSH 4
    MUL
    ADD
    %stack (off) -> ({_SEG}, off, 4, sha2_w16b)
    PUSH load_be
    JUMP
sha2_w16b:
    // w, ret'
{_load(L_T)}
    PUSH {W_BASE}
    ADD
{_store_at_top()}
{_load(L_T)}
    PUSH 1
    ADD
{_store(L_T)}
    PUSH sha2_w16
    JUMP
sha2_w64:
    // W[16..64): sigma recurrence
{_load(L_T)}
    PUSH 64
    SWAP1
    LT
    ISZERO
    PUSH sha2_rounds_init
    JUMPI
    // s1 = sigma1(W[t-2]); s0 = sigma0(W[t-15])
{_load(L_T)}
    PUSH 2
    SWAP1
    SUB
    PUSH {W_BASE}
    ADD
{_load_at_top()}
{_small_sigma(17, 19, 10)}
{_load(L_T)}
    PUSH 7
    SWAP1
    SUB
    PUSH {W_BASE}
    ADD
{_load_at_top()}
    ADD
{_load(L_T)}
    PUSH 15
    SWAP1
    SUB
    PUSH {W_BASE}
    ADD
{_load_at_top()}
{_small_sigma(7, 18, 3)}
    ADD
{_load(L_T)}
    PUSH 16
    SWAP1
    SUB
    PUSH {W_BASE}
    ADD
{_load_at_top()}
    ADD
{_mod32()}
{_load(L_T)}
    PUSH {W_BASE}
    ADD
{_store_at_top()}
{_load(L_T)}
    PUSH 1
    ADD
{_store(L_T)}
    PUSH sha2_w64
    JUMP
"""
    # a..h = H0..H7
    rounds_init = "sha2_rounds_init:\n"
    for i in range(8):
        rounds_init += _load(H_BASE + i) + _store(A_BASE + i)
    rounds_init += f"""
    PUSH 0
{_store(L_T)}
"""
    # round loop
    a, b, c, d, e, f_, g, h = [A_BASE + i for i in range(8)]
    round_loop = f"""
sha2_round:
{_load(L_T)}
    PUSH 64
    SWAP1
    LT
    ISZERO
    PUSH sha2_blk_done
    JUMPI
    // T1 = h + S1(e) + Ch(e,f,g) + K[t] + W[t]
{_load(h)}
{_load(e)}
{_big_sigma(6, 11, 25)}
    ADD
    // ch = (e & f) ^ (~e & g)
{_load(e)}
{_load(f_)}
    AND
{_load(e)}
    PUSH 0xFFFFFFFF
    XOR
{_load(g)}
    AND
    XOR
    ADD
{_load(L_T)}
    PUSH {K_BASE}
    ADD
{_load_at_top()}
    ADD
{_load(L_T)}
    PUSH {W_BASE}
    ADD
{_load_at_top()}
    ADD
{_mod32()}
{_store(L_T1)}
    // T2 = S0(a) + Maj(a,b,c)
{_load(a)}
{_big_sigma(2, 13, 22)}
{_load(a)}
{_load(b)}
    AND
{_load(a)}
{_load(c)}
    AND
    XOR
{_load(b)}
{_load(c)}
    AND
    XOR
    ADD
{_mod32()}
{_store(L_T2)}
    // rotate state
{_load(g)}
{_store(h)}
{_load(f_)}
{_store(g)}
{_load(e)}
{_store(f_)}
{_load(d)}
{_load(L_T1)}
    ADD
{_mod32()}
{_store(e)}
{_load(c)}
{_store(d)}
{_load(b)}
{_store(c)}
{_load(a)}
{_store(b)}
{_load(L_T1)}
{_load(L_T2)}
    ADD
{_mod32()}
{_store(a)}
{_load(L_T)}
    PUSH 1
    ADD
{_store(L_T)}
    PUSH sha2_round
    JUMP
sha2_blk_done:
"""
    # H += a..h
    blk_done = ""
    for i in range(8):
        blk_done += (_load(H_BASE + i) + _load(A_BASE + i)
                     + "    ADD\n" + _mod32() + _store(H_BASE + i))
    blk_done += f"""
{_load(L_BLK)}
    PUSH 1
    ADD
{_store(L_BLK)}
    PUSH sha2_blk_loop
    JUMP
"""
    # digest = H0..H7 big-endian concat
    finish = "sha2_finish:\n    PUSH 0\n"
    for i in range(8):
        finish += f"""
    PUSH 0x100000000
    MUL
{_load(H_BASE + i)}
    ADD
"""
    finish += """
    // digest, ret
    SWAP1
    JUMP
"""
    return head + init + block_loop + rounds_init + round_loop + blk_done \
        + finish



# ---------------------------------------------------------------------------
# RIPEMD-160 (spec: cpu/kernel/tests/ripemd.rs; little-endian words)
# ---------------------------------------------------------------------------

_R_L = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
        3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
        1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
        4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]
_R_R = [5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
        6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
        15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
        8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
        12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]
_S_L = [11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
        7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
        11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
        11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
        9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]
_S_R = [8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
        9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
        9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
        15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
        8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]
_K_L = [0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_K_R = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000]
_H160 = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]

RL_BASE, RR_BASE = 21000, 21080
SL_BASE, SR_BASE = 21200, 21280
RH_BASE = 21400            # h0..h4
RA_BASE = 21410            # left line A..E
RB_BASE = 21420            # right line A'..E'
RX_BASE = 21500            # X[0..16)
RL_LOC = 21600             # locals: len, nblk, blk, j, line(K base etc.)
P2_BASE = 21700            # pow2 table [0..32]
RK_BASE = 21740            # K left 5 + K right 5

R_LEN, R_NBLK, R_BLK, R_J, R_T = (RL_LOC, RL_LOC + 1, RL_LOC + 2,
                                  RL_LOC + 3, RL_LOC + 4)


def _rotl32_var() -> str:
    """(x, n) -> (rotl32(x, n)) with runtime n via the pow2 table."""
    return f"""
    // x, n
    DUP2
    PUSH {P2_BASE}
    ADD
{_load_at_top()}
    // 2^n, x, n
    DUP2
    MUL
    PUSH 0x100000000
    SWAP1
    MOD
    // lo = (x << n) mod 2^32, x, n
    %stack (lo, x, n) -> (32, n, x, lo)
    SUB
    PUSH {P2_BASE}
    ADD
{_load_at_top()}
    // 2^(32-n), x, lo
    SWAP1
    DIV
    // x >> (32-n), lo
    ADD
"""


def _rmd_f(g: int) -> str:
    """(x, y, z) -> (f_g(x, y, z)); the five RIPEMD round functions."""
    if g == 0:
        return "    XOR\n    XOR\n"
    if g == 1:   # (x & y) | (~x & z)
        return """
    %stack (x, y, z) -> (x, y, x, z)
    AND
    %stack (t, x, z) -> (x, 0xFFFFFFFF, z, t)
    XOR
    AND
    OR
"""
    if g == 2:   # (x | ~y) ^ z
        return """
    %stack (x, y, z) -> (y, 0xFFFFFFFF, x, z)
    XOR
    OR
    XOR
"""
    if g == 3:   # (x & z) | (y & ~z)
        return """
    %stack (x, y, z) -> (x, z, y, z)
    AND
    %stack (t, y, z) -> (z, 0xFFFFFFFF, y, t)
    XOR
    AND
    OR
"""
    # g == 4: x ^ (y | ~z)
    return """
    %stack (x, y, z) -> (z, 0xFFFFFFFF, y, x)
    XOR
    OR
    XOR
"""


def _rmd_line(name: str, st: int, r_base: int, s_base: int, k_off: int,
              f_rev: bool) -> str:
    """One 80-step line; state at `st` (A..E), tables at r_base/s_base,
    K at RK_BASE + k_off + group."""
    A, B, C, D, E = st, st + 1, st + 2, st + 3, st + 4
    # f dispatch: group g = j // 16; f index = g (left) or 4-g (right)
    f_branches = ""
    for g in range(5):
        fidx = 4 - g if f_rev else g
        f_branches += f"""
{name}_f{g}:
{_rmd_f(fidx)}
    PUSH {name}_fdone
    JUMP
"""
    dispatch = ""
    for g in range(5):
        dispatch += f"""
    DUP1
    PUSH {g}
    EQ
    PUSH {name}_dispatch{g}
    JUMPI
"""
    dispatch_arms = ""
    for g in range(5):
        dispatch_arms += f"""
{name}_dispatch{g}:
    POP
    PUSH {name}_f{g}
    JUMP
"""
    return f"""
{name}:
{_load(R_J)}
    PUSH 80
    SWAP1
    LT
    ISZERO
    PUSH {name}_done
    JUMPI
    // T = rotl(A + f(B,C,D) + X[r[j]] + K[g], s[j]) + E
{_load(D)}
{_load(C)}
{_load(B)}
    // x=B, y=C, z=D (top-down) — dispatch on g = j // 16
{_load(R_J)}
    PUSH 16
    SWAP1
    DIV
{dispatch}
    PANIC
{dispatch_arms}
{f_branches}
{name}_fdone:
    // f, (rest empty)
{_load(A)}
    ADD
{_load(R_J)}
    PUSH {r_base}
    ADD
{_load_at_top()}
    PUSH {RX_BASE}
    ADD
{_load_at_top()}
    ADD
{_load(R_J)}
    PUSH 16
    SWAP1
    DIV
    PUSH {RK_BASE + k_off}
    ADD
{_load_at_top()}
    ADD
{_mod32()}
    // sum, — rotl by s[j]
{_load(R_J)}
    PUSH {s_base}
    ADD
{_load_at_top()}
    SWAP1
{_rotl32_var()}
{_load(E)}
    ADD
{_mod32()}
    // T
    // A=E; E=D; D=rotl10(C); C=B; B=T
{_load(E)}
{_store(A)}
{_load(D)}
{_store(E)}
{_load(C)}
    PUSH 10
    SWAP1
{_rotl32_var()}
{_store(D)}
{_load(B)}
{_store(C)}
{_store(B)}
{_load(R_J)}
    PUSH 1
    ADD
{_store(R_J)}
    PUSH {name}
    JUMP
{name}_done:
"""


def _ripemd_asm() -> str:
    head = f"""
// (len, byte0, ..., retdest) -> (ripemd160 digest)
GLOBAL ripemd:
    DUP1
{_store(R_LEN)}
    PUSH 0
rmd_copy:
    DUP2
    DUP2
    EQ
    PUSH rmd_copied
    JUMPI
    %stack (i, len, b) -> (0, {_SEG}, i, b, i, len)
    MSTORE_GENERAL
    PUSH 1
    ADD
    PUSH rmd_copy
    JUMP
rmd_copied:
    POP
    POP
    // padding: 0x80 then zeros to P-8, LITTLE-endian 8-byte bit length
{_load(R_LEN)}
    PUSH 0x80
    DUP2
    %stack (addr, v, len) -> (0, {_SEG}, addr, v, len)
    MSTORE_GENERAL
    DUP1
    PUSH 8
    ADD
    PUSH 64
    SWAP1
    DIV
    PUSH 1
    ADD
    PUSH 64
    MUL
    // P, len
    DUP1
    PUSH 64
    SWAP1
    DIV
{_store(R_NBLK)}
    SWAP1
    PUSH 1
    ADD
    // z = len+1, P
rmd_zero:
    DUP2
    PUSH 8
    SWAP1
    SUB
    DUP2
    EQ
    PUSH rmd_zeroed
    JUMPI
    DUP1
    %stack (addr) -> (0, {_SEG}, addr, 0)
    MSTORE_GENERAL
    PUSH 1
    ADD
    PUSH rmd_zero
    JUMP
rmd_zeroed:
    // z(=P-8), P — little-endian bit length: bytes of 8*len, LSB first
{_load(R_LEN)}
    PUSH 8
    MUL
    // bits, z, P
    SWAP1
    PUSH 0
    // k, z, bits, P
rmd_lenw:
    DUP1
    PUSH 8
    EQ
    PUSH rmd_lenw_done
    JUMPI
    // byte = (bits >> 8k) & 0xFF — iteratively: store bits&0xFF, bits>>=8
    DUP3
    PUSH 0x100
    SWAP1
    MOD
    // byte, k, z, bits, P
    DUP3
    DUP3
    ADD
    // z+k, byte, k, z, bits, P
    %stack (addr, byte) -> (0, {_SEG}, addr, byte)
    MSTORE_GENERAL
    // k, z, bits, P
    SWAP2
    PUSH 0x100
    SWAP1
    DIV
    SWAP2
    // k, z, bits>>8, P
    PUSH 1
    ADD
    PUSH rmd_lenw
    JUMP
rmd_lenw_done:
    POP
    POP
    POP
    POP
    // (ret)
"""
    init = (_table_init(RL_BASE, _R_L) + _table_init(RR_BASE, _R_R)
            + _table_init(SL_BASE, _S_L) + _table_init(SR_BASE, _S_R)
            + _table_init(RH_BASE, _H160)
            + _table_init(P2_BASE, [1 << i for i in range(33)])
            + _table_init(RK_BASE, _K_L) + _table_init(RK_BASE + 5, _K_R))
    blocks = f"""
    PUSH 0
{_store(R_BLK)}
rmd_blk_loop:
{_load(R_BLK)}
{_load(R_NBLK)}
    EQ
    PUSH rmd_finish
    JUMPI
    // X[0..16) = little-endian words
    PUSH 0
{_store(R_J)}
rmd_x16:
{_load(R_J)}
    PUSH 16
    SWAP1
    LT
    ISZERO
    PUSH rmd_lines
    JUMPI
    // word = b0 + 256*b1 + 2^16*b2 + 2^24*b3 at off = blk*64 + j*4
{_load(R_BLK)}
    PUSH 64
    MUL
{_load(R_J)}
    PUSH 4
    MUL
    ADD
    // off
    DUP1
    PUSH 3
    ADD
{_load_at_top()}
    PUSH 0x100
    MUL
    DUP2
    PUSH 2
    ADD
{_load_at_top()}
    ADD
    PUSH 0x100
    MUL
    DUP2
    PUSH 1
    ADD
{_load_at_top()}
    ADD
    PUSH 0x100
    MUL
    DUP2
{_load_at_top()}
    ADD
    // word, off
    SWAP1
    POP
{_load(R_J)}
    PUSH {RX_BASE}
    ADD
{_store_at_top()}
{_load(R_J)}
    PUSH 1
    ADD
{_store(R_J)}
    PUSH rmd_x16
    JUMP
rmd_lines:
    // left line state = h, right line state = h
"""
    for i in range(5):
        blocks += _load(RH_BASE + i) + _store(RA_BASE + i)
        blocks += _load(RH_BASE + i) + _store(RB_BASE + i)
    blocks += f"""
    PUSH 0
{_store(R_J)}
"""
    left = _rmd_line("rmd_left", RA_BASE, RL_BASE, SL_BASE, 0, False)
    mid = f"""
    PUSH 0
{_store(R_J)}
"""
    right = _rmd_line("rmd_right", RB_BASE, RR_BASE, SR_BASE, 5, True)
    # combine: T = h1 + C + D'; h1 = h2 + D + E'; h2 = h3 + E + A';
    # h3 = h4 + A + B'; h4 = h0 + B + C'; h0 = T
    h = [RH_BASE + i for i in range(5)]
    A, B, C, D, E = [RA_BASE + i for i in range(5)]
    A2, B2, C2, D2, E2 = [RB_BASE + i for i in range(5)]
    combine = ""
    for dst_tmp, (x, y, z) in [(R_T, (h[1], C, D2)),
                               (h[1], (h[2], D, E2)),
                               (h[2], (h[3], E, A2)),
                               (h[3], (h[4], A, B2)),
                               (h[4], (h[0], B, C2))]:
        combine += (_load(x) + _load(y) + "    ADD\n" + _load(z)
                    + "    ADD\n" + _mod32() + _store(dst_tmp))
    combine += _load(R_T) + _store(h[0])
    combine += f"""
{_load(R_BLK)}
    PUSH 1
    ADD
{_store(R_BLK)}
    PUSH rmd_blk_loop
    JUMP
"""
    # digest: LITTLE-endian per word, words h0..h4 in order -> big-endian
    # 160-bit integer = bytes(h0 LE) || ... || bytes(h4 LE)
    finish = "rmd_finish:\n    PUSH 0\n"
    for i in range(5):
        # byteswap32(h_i) appended
        finish += f"""
    PUSH 0x100000000
    MUL
{_load(RH_BASE + i)}
    // byteswap 32-bit: b0<<24 | b1<<16 | b2<<8 | b3
    DUP1
    PUSH 0x100
    SWAP1
    MOD
    PUSH 0x1000000
    MUL
    SWAP1
    DUP1
    PUSH 0x100
    SWAP1
    DIV
    PUSH 0x100
    SWAP1
    MOD
    PUSH 0x10000
    MUL
    SWAP1
    DUP1
    PUSH 0x10000
    SWAP1
    DIV
    PUSH 0x100
    SWAP1
    MOD
    PUSH 0x100
    MUL
    SWAP1
    PUSH 0x1000000
    SWAP1
    DIV
    ADD
    ADD
    ADD
    ADD
"""
    finish += """
    SWAP1
    JUMP
"""
    return head + init + blocks + left + mid + right + combine + finish



# ---------------------------------------------------------------------------
# BLAKE2b-512, unkeyed (spec: cpu/kernel/tests/hash.rs test_blake2b)
# ---------------------------------------------------------------------------

_IV64 = [0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b,
         0xa54ff53a5f1d36f1, 0x510e527fade682d1, 0x9b05688c2b3e6c1f,
         0x1f83d9abfb41bd6b, 0x5be0cd19137e2179]
_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
_MASK64 = (1 << 64) - 1

BV_BASE = 22200   # v[0..16)
BH_BASE = 22300   # h[0..8)
BM_BASE = 22400   # m[0..16)
BL_BASE = 22500   # locals
B_LEN, B_NBLK, B_BLK = BL_BASE, BL_BASE + 1, BL_BASE + 2


def _mod64() -> str:
    return f"""
    PUSH {1 << 64}
    SWAP1
    MOD
"""


def _rotr64(n: int) -> str:
    """(x) -> (rotr64(x, n))"""
    return f"""
    DUP1
    PUSH {1 << n}
    SWAP1
    DIV
    SWAP1
    PUSH {1 << n}
    SWAP1
    MOD
    PUSH {1 << (64 - n)}
    MUL
    ADD
"""


def _blake_g(a: int, b: int, c: int, d: int, x: int, y: int) -> str:
    """One G mixing step on v-slots with constant m-slots x, y."""
    va, vb, vc, vd = BV_BASE + a, BV_BASE + b, BV_BASE + c, BV_BASE + d
    mx, my = BM_BASE + x, BM_BASE + y
    out = ""
    # a = a + b + m[x]
    out += _load(va) + _load(vb) + "    ADD\n" + _load(mx) + "    ADD\n" \
        + _mod64() + _store(va)
    # d = rotr64(d ^ a, 32)
    out += _load(vd) + _load(va) + "    XOR\n" + _rotr64(32) + _store(vd)
    # c = c + d
    out += _load(vc) + _load(vd) + "    ADD\n" + _mod64() + _store(vc)
    # b = rotr64(b ^ c, 24)
    out += _load(vb) + _load(vc) + "    XOR\n" + _rotr64(24) + _store(vb)
    # a = a + b + m[y]
    out += _load(va) + _load(vb) + "    ADD\n" + _load(my) + "    ADD\n" \
        + _mod64() + _store(va)
    # d = rotr64(d ^ a, 16)
    out += _load(vd) + _load(va) + "    XOR\n" + _rotr64(16) + _store(vd)
    # c = c + d
    out += _load(vc) + _load(vd) + "    ADD\n" + _mod64() + _store(vc)
    # b = rotr64(b ^ c, 63)
    out += _load(vb) + _load(vc) + "    XOR\n" + _rotr64(63) + _store(vb)
    return out


def _blake2b_asm() -> str:
    head = f"""
// (len, byte0, ..., retdest) -> (hi, lo): blake2b-512 digest halves,
// hi = big-endian int of digest bytes [0, 32), lo = bytes [32, 64)
GLOBAL blake2b:
    DUP1
{_store(B_LEN)}
    PUSH 0
b2b_copy:
    DUP2
    DUP2
    EQ
    PUSH b2b_copied
    JUMPI
    %stack (i, len, b) -> (0, {_SEG}, i, b, i, len)
    MSTORE_GENERAL
    PUSH 1
    ADD
    PUSH b2b_copy
    JUMP
b2b_copied:
    POP
    POP
    // nblocks = max(1, ceil(len / 128)); zero-pad [len, nblocks*128)
{_load(B_LEN)}
    PUSH 127
    ADD
    PUSH 128
    SWAP1
    DIV
    DUP1
    ISZERO
    PUSH b2b_atleast1
    JUMPI
    PUSH b2b_nblk
    JUMP
b2b_atleast1:
    POP
    PUSH 1
b2b_nblk:
{_store(B_NBLK)}
    // zero tail
{_load(B_LEN)}
{_load(B_NBLK)}
    PUSH 128
    MUL
    // end, z=len
    SWAP1
b2b_zero:
    DUP2
    DUP2
    EQ
    PUSH b2b_zeroed
    JUMPI
    DUP1
    %stack (addr) -> (0, {_SEG}, addr, 0)
    MSTORE_GENERAL
    PUSH 1
    ADD
    PUSH b2b_zero
    JUMP
b2b_zeroed:
    POP
    POP
"""
    # h init: IV with h0 ^= 0x01010040
    init = ""
    for i, v in enumerate(_IV64):
        hv = v ^ 0x01010040 if i == 0 else v
        init += f"""
    PUSH {hv}
{_store(BH_BASE + i)}
"""
    init += f"""
    PUSH 0
{_store(B_BLK)}
"""
    # per block
    blk_head = f"""
b2b_blk_loop:
{_load(B_BLK)}
{_load(B_NBLK)}
    EQ
    PUSH b2b_finish
    JUMPI
    // m[0..16) = little-endian 8-byte words at blk*128 + j*8
"""
    m_loads = ""
    for j in range(16):
        m_loads += f"""
{_load(B_BLK)}
    PUSH 128
    MUL
    PUSH {j * 8}
    ADD
    // off
"""
        # LE 8-byte assemble: ((..(b7)*256 + b6)..)*256 + b0
        m_loads += """
    PUSH 0
"""
        for k in range(7, -1, -1):
            m_loads += f"""
    PUSH 0x100
    MUL
    DUP2
    PUSH {k}
    ADD
{_load_at_top()}
    ADD
"""
        m_loads += f"""
    SWAP1
    POP
{_store(BM_BASE + j)}
"""
    # v init
    v_init = ""
    for i in range(8):
        v_init += _load(BH_BASE + i) + _store(BV_BASE + i)
    for i in range(8):
        v_init += f"    PUSH {_IV64[i]}\n" + _store(BV_BASE + 8 + i)
    # v12 ^= t; t = (blk == nblk-1) ? len : (blk+1)*128
    v_init += f"""
{_load(B_BLK)}
    PUSH 1
    ADD
{_load(B_NBLK)}
    EQ
    PUSH b2b_t_final
    JUMPI
{_load(B_BLK)}
    PUSH 1
    ADD
    PUSH 128
    MUL
    PUSH b2b_t_have
    JUMP
b2b_t_final:
{_load(B_LEN)}
b2b_t_have:
{_load(BV_BASE + 12)}
    XOR
{_store(BV_BASE + 12)}
    // v14 ^= -1 on the final block
{_load(B_BLK)}
    PUSH 1
    ADD
{_load(B_NBLK)}
    EQ
    ISZERO
    PUSH b2b_rounds
    JUMPI
{_load(BV_BASE + 14)}
    PUSH {_MASK64}
    XOR
{_store(BV_BASE + 14)}
b2b_rounds:
"""
    # 12 unrolled rounds
    rounds = ""
    for r in range(12):
        sg = _SIGMA[r % 10]
        rounds += _blake_g(0, 4, 8, 12, sg[0], sg[1])
        rounds += _blake_g(1, 5, 9, 13, sg[2], sg[3])
        rounds += _blake_g(2, 6, 10, 14, sg[4], sg[5])
        rounds += _blake_g(3, 7, 11, 15, sg[6], sg[7])
        rounds += _blake_g(0, 5, 10, 15, sg[8], sg[9])
        rounds += _blake_g(1, 6, 11, 12, sg[10], sg[11])
        rounds += _blake_g(2, 7, 8, 13, sg[12], sg[13])
        rounds += _blake_g(3, 4, 9, 14, sg[14], sg[15])
    # h ^= v[i] ^ v[i+8]
    fold = ""
    for i in range(8):
        fold += (_load(BH_BASE + i) + _load(BV_BASE + i) + "    XOR\n"
                 + _load(BV_BASE + 8 + i) + "    XOR\n"
                 + _store(BH_BASE + i))
    fold += f"""
{_load(B_BLK)}
    PUSH 1
    ADD
{_store(B_BLK)}
    PUSH b2b_blk_loop
    JUMP
"""
    # digest: byteswap64 of h_i, hi = h0..h3, lo = h4..h7; return (hi, lo)
    def bswap64() -> str:
        # (x) -> (byteswap64(x)): invariant per iteration (x, acc)
        out = """
    PUSH 0
    SWAP1
"""
        for _ in range(8):
            out += """
    DUP1
    PUSH 0x100
    SWAP1
    MOD
    %stack (b, x, acc) -> (acc, 0x100, b, x)
    MUL
    ADD
    SWAP1
    PUSH 0x100
    SWAP1
    DIV
"""
        out += """
    POP
"""
        return out

    finish = "b2b_finish:\n    PUSH 0\n"
    for i in range(4):
        finish += f"""
    PUSH {1 << 64}
    MUL
{_load(BH_BASE + i)}
{bswap64()}
    ADD
"""
    finish += "    PUSH 0\n"
    for i in range(4, 8):
        finish += f"""
    PUSH {1 << 64}
    MUL
{_load(BH_BASE + i)}
{bswap64()}
    ADD
"""
    finish += """
    // lo, hi, ret
    %stack (lo, hi, ret) -> (ret, hi, lo)
    JUMP
"""
    return head + init + blk_head + m_loads + v_init + rounds + fold \
        + finish


HASHES_ASM = _sha2_asm() + _ripemd_asm() + _blake2b_asm()


