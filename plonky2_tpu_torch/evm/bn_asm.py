"""In-kernel BN254 (alt_bn128) G1 curve arithmetic — the ecAdd / ecMul
precompile routines.

Reference correspondence: the kernel's curve_add/curve_mul asm (sources
absent from its tree; behavior spec'd by cpu/kernel/tests/curve_ops.rs
`mod bn`): points travel as (x, y) with x on top, identity = (0, 0);
`ec_add` / `ec_mul` validate their input points (on-curve y² = x³ + 3
with x, y < p, or the identity) and return (U256_MAX, U256_MAX) for
invalid inputs; `ec_double` mirrors curve doubling directly.

Same soundness profile as secp_asm.py: every modular step is an
ADDMOD/MULMOD/DIV/MOD bound to the arithmetic table by the cross-table
lookups, and field inverses are PROVER_INPUT(ff::bn254_base::inverse)
hints verified in-kernel.
"""

BN_ASM = """
%macro mulmodbn
    %stack (a, b) -> (a, b, @BN_BASE)
    MULMOD
%endmacro

%macro addmodbn
    %stack (a, b) -> (a, b, @BN_BASE)
    ADDMOD
%endmacro

%macro submodbn
    // (a, b) -> (a - b mod p); requires b <= p
    %stack (a, b) -> (@BN_BASE, b, a)
    SUB
    %stack (pb, a) -> (pb, a, @BN_BASE)
    ADDMOD
%endmacro

%macro inverse_bn
    // (x) -> (x^-1 mod p); x nonzero, else PANIC
    PROVER_INPUT(ff::bn254_base::inverse)
    DUP2
    DUP2
    %mulmodbn
    PUSH 1
    EQ
    PUSH %%ok
    JUMPI
    PANIC
%%ok:
    SWAP1
    POP
%endmacro

// (x, y, ret) -> (valid): 1 iff (x, y) is on the curve or the identity
GLOBAL bn_is_valid:
    DUP2
    ISZERO
    DUP2
    ISZERO
    MUL
    PUSH bnv_id
    JUMPI
    // x < p, y < p
    PUSH @BN_BASE
    DUP2
    LT
    PUSH @BN_BASE
    DUP4
    LT
    MUL
    // f, x, y, ret
    // y² == x³ + 3
    DUP3
    DUP1
    %mulmodbn
    // y², f, x, y, ret
    DUP3
    DUP1
    %mulmodbn
    DUP4
    %mulmodbn
    PUSH 3
    %addmodbn
    // x³+3, y², f, x, y, ret
    EQ
    MUL
    %stack (v, x, y, ret) -> (ret, v)
    JUMP
bnv_id:
    %stack (x, y, ret) -> (ret, 1)
    JUMP

// (x, y, ret) -> (x2, y2): doubling (identity passes through)
GLOBAL ec_double:
    DUP1
    ISZERO
    PUSH bnd_identity
    JUMPI
    DUP2
    DUP1
    %addmodbn
    %inverse_bn
    DUP2
    DUP1
    %mulmodbn
    PUSH 3
    %mulmodbn
    %mulmodbn
    // lam, x, y, ret
    DUP1
    DUP1
    %mulmodbn
    DUP3
    DUP1
    %addmodbn
    SWAP1
    %submodbn
    // x2, lam, x, y, ret
    DUP1
    DUP4
    %submodbn
    DUP3
    %mulmodbn
    DUP5
    SWAP1
    %submodbn
    %stack (y2, x2, lam, x, y, ret) -> (ret, x2, y2)
    JUMP
bnd_identity:
    %stack (x, y, ret) -> (ret, x, y)
    JUMP

// internal unvalidated addition (callers validated already)
GLOBAL bn_add_raw:
    DUP1
    ISZERO
    PUSH bna_p1_id
    JUMPI
    DUP3
    ISZERO
    PUSH bna_p2_id
    JUMPI
    DUP3
    DUP2
    EQ
    PUSH bna_same_x
    JUMPI
    DUP1
    DUP4
    %submodbn
    %inverse_bn
    DUP3
    DUP6
    %submodbn
    %mulmodbn
    // lam, x1, y1, x2, y2, ret
    DUP1
    DUP1
    %mulmodbn
    DUP3
    SWAP1
    %submodbn
    DUP5
    SWAP1
    %submodbn
    // x3, lam, x1, y1, x2, y2, ret
    DUP1
    DUP4
    %submodbn
    DUP3
    %mulmodbn
    DUP5
    SWAP1
    %submodbn
    %stack (y3, x3, lam, x1, y1, x2, y2, ret) -> (ret, x3, y3)
    JUMP
bna_p1_id:
    %stack (x1, y1, x2, y2, ret) -> (ret, x2, y2)
    JUMP
bna_p2_id:
    %stack (x1, y1, x2, y2, ret) -> (ret, x1, y1)
    JUMP
bna_same_x:
    DUP4
    DUP3
    EQ
    ISZERO
    PUSH bna_inverse
    JUMPI
    %stack (x1, y1, x2, y2, ret) -> (x1, y1, ret)
    PUSH ec_double
    JUMP
bna_inverse:
    %stack (x1, y1, x2, y2, ret) -> (ret, 0, 0)
    JUMP

// (x1, y1, x2, y2, ret) -> (x3, y3) | (MAX, MAX): validated addition
GLOBAL ec_add:
    DUP2
    DUP2
    %stack (x1, y1) -> (x1, y1, eca_v1)
    PUSH bn_is_valid
    JUMP
eca_v1:
    ISZERO
    PUSH eca_invalid
    JUMPI
    DUP4
    DUP4
    %stack (x2, y2) -> (x2, y2, eca_v2)
    PUSH bn_is_valid
    JUMP
eca_v2:
    ISZERO
    PUSH eca_invalid
    JUMPI
    PUSH bn_add_raw
    JUMP
eca_invalid:
    %stack (x1, y1, x2, y2, ret) -> (ret, @U256_MAX, @U256_MAX)
    JUMP

// (x, y, s, ret) -> (sx, sy) | (MAX, MAX): validated scalar multiplication
GLOBAL ec_mul:
    DUP2
    DUP2
    %stack (x, y) -> (x, y, ecm_v)
    PUSH bn_is_valid
    JUMP
ecm_v:
    ISZERO
    PUSH ecm_invalid
    JUMPI
    // double-and-add (k >>= 1 via DIV, arithmetic-table bound)
    %stack (x, y, s) -> (s, x, y, 0, 0)
    // k, bx, by, ax, ay, ret
ecm_loop:
    DUP1
    ISZERO
    PUSH ecm_done
    JUMPI
    DUP1
    PUSH 1
    AND
    ISZERO
    PUSH ecm_skip
    JUMPI
    %stack (k, bx, by, ax, ay) -> (bx, by, ax, ay, ecm_added, k, bx, by)
    PUSH bn_add_raw
    JUMP
ecm_added:
    %stack (ax, ay, k, bx, by) -> (k, bx, by, ax, ay)
ecm_skip:
    %stack (k, bx, by) -> (bx, by, ecm_doubled, k)
    PUSH ec_double
    JUMP
ecm_doubled:
    %stack (bx, by, k) -> (k, bx, by)
    %stack (k) -> (k, 2)
    DIV
    PUSH ecm_loop
    JUMP
ecm_done:
    %stack (k, bx, by, ax, ay, ret) -> (ret, ax, ay)
    JUMP
ecm_invalid:
    %stack (x, y, s, ret) -> (ret, @U256_MAX, @U256_MAX)
    JUMP
"""
