"""The port's copy of plonky2_tpu/evm/secp_asm.py.

In-kernel secp256k1: affine curve arithmetic, scalar multiplication and
`ecrecover` — the routine library that binds a block proof's transfers to
their transaction signatures.

Reference correspondence: the reference kernel's curve/ecrecover asm
(sources absent from its tree; behavior spec'd by
cpu/kernel/tests/ecrecover.rs:10-27 — `ecrecover(hash, v, r, s, retdest)`
returns the 160-bit address, or U256_MAX for invalid inputs — and
tests/curve_ops.rs conventions: points travel as (x, y) with x on top and
(0, 0) as the identity).

Soundness: every 256-bit modular step executes as ADDMOD / MULMOD /
DIV / MOD, all bound to the arithmetic table by cross-table lookups
(all_stark.ctl_arithmetic_ternary / _div / _mod); field inverses and the
candidate-point square root are nondeterministic PROVER_INPUT hints
verified in-kernel (inv·x ≡ 1, y·y ≡ x³+7).  The unconstrained BYTE
opcode and the shift table are avoided throughout.

secp256k1 has no 2-torsion (prime group order), so no valid point has
y = 0, and x = 0 is not on the curve (7 is not a QR mod p) — (0, 0) is
therefore a safe identity sentinel and `x == 0` a complete identity test.

The Ethereum precompile semantics pin the recovery x-coordinate to r
itself; the "r + n overflow" candidate (R.x = r + n < p) is NOT
recoverable through v ∈ {27, 28} and is rejected by the r < n check
(ecdsa/curve.py handles it the same way).
"""

SECP_ASM = """
// ---------------------------------------------------------------------------
// modular helpers (p = secp256k1 base field, n = scalar field)
// ---------------------------------------------------------------------------

%macro mulmodp
    // stack: (a, b) -> (a*b mod p)
    %stack (a, b) -> (a, b, @SECP_BASE)
    MULMOD
%endmacro

%macro addmodp
    %stack (a, b) -> (a, b, @SECP_BASE)
    ADDMOD
%endmacro

%macro submodp
    // (a, b) -> (a - b mod p); requires b <= p
    %stack (a, b) -> (@SECP_BASE, b, a)
    SUB
    // p-b, a
    %stack (pb, a) -> (pb, a, @SECP_BASE)
    ADDMOD
%endmacro

%macro mulmodn
    %stack (a, b) -> (a, b, @SECP_SCALAR)
    MULMOD
%endmacro

%macro inverse_base
    // (x) -> (x^-1 mod p); x must be nonzero mod p, else PANIC
    PROVER_INPUT(ff::secp256k1_base::inverse)
    // inv, x
    DUP2
    DUP2
    %mulmodp
    // inv*x mod p, inv, x
    PUSH 1
    EQ
    PUSH %%ok
    JUMPI
    PANIC
%%ok:
    // inv, x
    SWAP1
    POP
%endmacro

%macro inverse_scalar
    // (x) -> (x^-1 mod n); x must be nonzero mod n, else PANIC
    PROVER_INPUT(ff::secp256k1_scalar::inverse)
    DUP2
    DUP2
    %mulmodn
    PUSH 1
    EQ
    PUSH %%ok
    JUMPI
    PANIC
%%ok:
    SWAP1
    POP
%endmacro

// ---------------------------------------------------------------------------
// affine point arithmetic; identity = (0, 0), x on top
// ---------------------------------------------------------------------------

// (x, y, ret) -> (x2, y2): point doubling
GLOBAL secp_double:
    DUP1
    ISZERO
    PUSH sd_identity
    JUMPI
    // lam = 3x^2 * inv(2y)
    DUP2
    DUP1
    %addmodp
    // 2y, x, y, ret
    %inverse_base
    // i, x, y, ret
    DUP2
    DUP1
    %mulmodp
    // x², i, x, y, ret
    PUSH 3
    %mulmodp
    %mulmodp
    // lam, x, y, ret
    // x2 = lam² - 2x
    DUP1
    DUP1
    %mulmodp
    // lam², lam, x, y, ret
    DUP3
    DUP1
    %addmodp
    // 2x, lam², lam, x, y, ret
    SWAP1
    %submodp
    // x2, lam, x, y, ret
    // y2 = lam*(x - x2) - y
    DUP1
    DUP4
    %submodp
    // x-x2, x2, lam, x, y, ret
    DUP3
    %mulmodp
    // lam(x-x2), x2, lam, x, y, ret
    DUP5
    SWAP1
    %submodp
    // y2, x2, lam, x, y, ret
    %stack (y2, x2, lam, x, y, ret) -> (ret, x2, y2)
    JUMP
sd_identity:
    %stack (x, y, ret) -> (ret, x, y)
    JUMP

// (x1, y1, x2, y2, ret) -> (x3, y3): general point addition
GLOBAL secp_add:
    DUP1
    ISZERO
    PUSH sa_p1_id
    JUMPI
    DUP3
    ISZERO
    PUSH sa_p2_id
    JUMPI
    DUP3
    DUP2
    EQ
    PUSH sa_same_x
    JUMPI
    // lam = (y2 - y1) * inv(x2 - x1)
    DUP1
    DUP4
    %submodp
    // dx=x2-x1, x1, y1, x2, y2, ret
    %inverse_base
    // idx, x1, y1, x2, y2, ret
    DUP3
    DUP6
    %submodp
    // dy=y2-y1, idx, x1, y1, x2, y2, ret
    %mulmodp
    // lam, x1, y1, x2, y2, ret
    // x3 = lam² - x1 - x2
    DUP1
    DUP1
    %mulmodp
    DUP3
    SWAP1
    %submodp
    DUP5
    SWAP1
    %submodp
    // x3, lam, x1, y1, x2, y2, ret
    // y3 = lam*(x1 - x3) - y1
    DUP1
    DUP4
    %submodp
    // x1-x3, x3, lam, x1, y1, x2, y2, ret
    DUP3
    %mulmodp
    // lam(x1-x3), x3, lam, x1, y1, x2, y2, ret
    DUP5
    SWAP1
    %submodp
    // y3, x3, lam, x1, y1, x2, y2, ret
    %stack (y3, x3, lam, x1, y1, x2, y2, ret) -> (ret, x3, y3)
    JUMP
sa_p1_id:
    %stack (x1, y1, x2, y2, ret) -> (ret, x2, y2)
    JUMP
sa_p2_id:
    %stack (x1, y1, x2, y2, ret) -> (ret, x1, y1)
    JUMP
sa_same_x:
    // x1 == x2: either the same point (double) or inverses (identity)
    DUP4
    DUP3
    EQ
    ISZERO
    PUSH sa_inverse
    JUMPI
    %stack (x1, y1, x2, y2, ret) -> (x1, y1, ret)
    PUSH secp_double
    JUMP
sa_inverse:
    %stack (x1, y1, x2, y2, ret) -> (ret, 0, 0)
    JUMP

// (k, x, y, ret) -> (qx, qy): binary double-and-add scalar multiplication;
// k >>= 1 runs as DIV (arithmetic-table bound) so no shift table is needed
GLOBAL secp_scalar_mul:
    %stack (k, x, y) -> (k, x, y, 0, 0)
    // k, bx, by, ax, ay, ret
sm_loop:
    DUP1
    ISZERO
    PUSH sm_done
    JUMPI
    DUP1
    PUSH 1
    AND
    ISZERO
    PUSH sm_skip
    JUMPI
    // acc += base
    %stack (k, bx, by, ax, ay) -> (bx, by, ax, ay, sm_added, k, bx, by)
    PUSH secp_add
    JUMP
sm_added:
    // ax', ay', k, bx, by, ret
    %stack (ax, ay, k, bx, by) -> (k, bx, by, ax, ay)
sm_skip:
    // base = 2*base
    %stack (k, bx, by) -> (bx, by, sm_doubled, k)
    PUSH secp_double
    JUMP
sm_doubled:
    // bx', by', k, ax, ay, ret
    %stack (bx, by, k) -> (k, bx, by)
    // k >>= 1
    %stack (k) -> (k, 2)
    DIV
    PUSH sm_loop
    JUMP
sm_done:
    %stack (k, bx, by, ax, ay, ret) -> (ret, ax, ay)
    JUMP

// ---------------------------------------------------------------------------
// ecrecover (spec: cpu/kernel/tests/ecrecover.rs)
// ---------------------------------------------------------------------------

// (qx, qy, ret) -> (addr): keccak(qx || qy as 64 BE bytes), low 160 bits
GLOBAL pubkey_to_addr:
    %stack (qx) -> (@SEGMENT_KERNEL_GENERAL_2, qx, 0, 32, pa_x_done)
    PUSH store_be
    JUMP
pa_x_done:
    // qy, ret
    %stack (qy) -> (@SEGMENT_KERNEL_GENERAL_2, qy, 32, 32, pa_y_done)
    PUSH store_be
    JUMP
pa_y_done:
    // ret
    %stack () -> (0, @SEGMENT_KERNEL_GENERAL_2, 0, 64)
    KECCAK_GENERAL
    // digest (LE-packed), ret
    %stack (d) -> (d, pa_swapped)
    PUSH u256_byteswap
    JUMP
pa_swapped:
    // digest (BE int), ret
    %stack (d) -> (d, @U160)
    MOD
    %stack (addr, ret) -> (ret, addr)
    JUMP

// (hash, v, r, s, ret) -> (addr | U256_MAX): Ethereum ecrecover.  v is the
// 27/28 recovery id; invalid inputs return U256_MAX (no panic), matching
// the reference's tests/ecrecover.rs contract.
GLOBAL ecrecover:
    // v in {27, 28}
    DUP2
    PUSH 27
    EQ
    DUP3
    PUSH 28
    EQ
    ADD
    ISZERO
    PUSH ec_invalid
    JUMPI
    // r in [1, n-1]
    DUP3
    ISZERO
    PUSH ec_invalid
    JUMPI
    PUSH @SECP_SCALAR
    DUP4
    LT
    ISZERO
    PUSH ec_invalid
    JUMPI
    // s in [1, n-1]
    DUP4
    ISZERO
    PUSH ec_invalid
    JUMPI
    PUSH @SECP_SCALAR
    DUP5
    LT
    ISZERO
    PUSH ec_invalid
    JUMPI
    // ysq = r³ + 7 mod p
    DUP3
    DUP1
    %mulmodp
    DUP4
    %mulmodp
    PUSH 7
    %addmodp
    // ysq, hash, v, r, s, ret
    // y = sqrt hint, verified; non-residue -> invalid signature
    DUP1
    PROVER_INPUT(ff::secp256k1_base::sqrt)
    // y, ysq, ysq, hash, v, r, s, ret
    DUP1
    DUP1
    %mulmodp
    // y², y, ysq, ysq, hash, v, r, s, ret
    %stack (ysq2, y, ysq) -> (ysq2, ysq, y)
    EQ
    ISZERO
    PUSH ec_invalid6
    JUMPI
    // y, ysq, hash, v, r, s, ret
    SWAP1
    POP
    // pick the root with parity v - 27
    DUP1
    PUSH 1
    AND
    DUP4
    PUSH 27
    SWAP1
    SUB
    // v-27, y&1, y, hash, v, r, s, ret
    EQ
    PUSH ec_parity_ok
    JUMPI
    PUSH @SECP_BASE
    SUB
ec_parity_ok:
    // y, hash, v, r, s, ret
    DUP4
    %inverse_scalar
    // rinv, y, hash, v, r, s, ret
    // u1 = (n - hash mod n) * rinv mod n
    DUP3
    %stack (h) -> (h, @SECP_SCALAR)
    MOD
    PUSH @SECP_SCALAR
    SUB
    DUP2
    %mulmodn
    // u1, rinv, y, hash, v, r, s, ret
    // u2 = s * rinv mod n
    DUP7
    DUP3
    %mulmodn
    // u2, u1, rinv, y, hash, v, r, s, ret
    %stack (u2, u1, rinv, y, hash, v, r, s) -> (u1, @SECP_GX, @SECP_GY, ec_g_done, u2, r, y)
    PUSH secp_scalar_mul
    JUMP
ec_g_done:
    // g1x, g1y, u2, r, y, ret
    %stack (g1x, g1y, u2, r, y) -> (u2, r, y, ec_r_done, g1x, g1y)
    PUSH secp_scalar_mul
    JUMP
ec_r_done:
    // p2x, p2y, g1x, g1y, ret
    %stack (p2x, p2y, g1x, g1y) -> (p2x, p2y, g1x, g1y, ec_q_done)
    PUSH secp_add
    JUMP
ec_q_done:
    // qx, qy, ret
    DUP1
    ISZERO
    PUSH ec_invalid2
    JUMPI
    %stack (qx, qy) -> (qx, qy, ec_addr_done)
    PUSH pubkey_to_addr
    JUMP
ec_addr_done:
    %stack (addr, ret) -> (ret, addr)
    JUMP
ec_invalid:
    %stack (a, b, c, d, ret) -> (ret, @U256_MAX)
    JUMP
ec_invalid2:
    %stack (a, b, ret) -> (ret, @U256_MAX)
    JUMP
ec_invalid6:
    %stack (a, b, c, d, e, f, ret) -> (ret, @U256_MAX)
    JUMP
"""
