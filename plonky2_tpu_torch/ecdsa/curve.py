"""Short-Weierstrass curve arithmetic over Python ints: the port's copy of
plonky2_tpu/ecdsa/curve.py (reference ecdsa/src/curve/{curve_types,
secp256k1,glv,curve_msm,ecdsa}.rs).

The host's curve: the witness generators and the tests use it; its
counterparts in a circuit are ecdsa/gadgets.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

# -- secp256k1 parameters (reference curve/secp256k1.rs, field/secp256k1_*.rs)

SECP256K1_P = \
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
SECP256K1_N = \
    0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP256K1_A = 0
SECP256K1_B = 7
SECP256K1_GX = \
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
SECP256K1_GY = \
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# GLV endomorphism constants (reference curve/glv.rs:11-35).
# beta is a cube root of unity in the base field; s the matching scalar.
GLV_BETA = 0x7AE96A2B657C07106E64479EAC3434E99CF0497512F58995C1396C28719501EE
GLV_S = 0x5363AD4CC05C30E0A5261C028812645A122E22EA20816678DF02967C1B23BD72
# lattice basis for the decomposition (a1, -b1, a2, b2)
GLV_A1 = 0x3086D221A7D46BCDE86C90E49284EB15
GLV_MINUS_B1 = 0xE4437ED6010E88286F547FA90ABFE4C3
GLV_A2 = 0x114CA50F7A8E2F3F657C1108D9D44CFD8
GLV_B2 = GLV_A1


@dataclass(frozen=True)
class CurveParams:
    p: int      # base field modulus
    n: int      # scalar field modulus (group order)
    a: int
    b: int
    gx: int
    gy: int


SECP256K1 = CurveParams(p=SECP256K1_P, n=SECP256K1_N, a=SECP256K1_A,
                        b=SECP256K1_B, gx=SECP256K1_GX, gy=SECP256K1_GY)


@dataclass(frozen=True)
class AffinePoint:
    curve: CurveParams
    x: int
    y: int
    zero: bool = False

    def is_valid(self) -> bool:
        if self.zero:
            return True
        p, a, b = self.curve.p, self.curve.a, self.curve.b
        return (self.y * self.y - (self.x ** 3 + a * self.x + b)) % p == 0

    def to_projective(self) -> "ProjectivePoint":
        if self.zero:
            return ProjectivePoint.zero(self.curve)
        return ProjectivePoint(self.curve, self.x, self.y, 1)

    def neg(self) -> "AffinePoint":
        if self.zero:
            return self
        return AffinePoint(self.curve, self.x, (-self.y) % self.curve.p)

    def double(self) -> "AffinePoint":
        return self.to_projective().double().to_affine()

    def add(self, other: "AffinePoint") -> "AffinePoint":
        return (self.to_projective() + other.to_projective()).to_affine()

    def __add__(self, other):
        return self.add(other)

    def __neg__(self):
        return self.neg()


@dataclass
class ProjectivePoint:
    """Jacobian-style projective coordinates (X/Z, Y/Z) with plain Z
    (homogeneous), mirroring reference curve_types.rs."""
    curve: CurveParams
    x: int
    y: int
    z: int

    @staticmethod
    def zero(curve: CurveParams) -> "ProjectivePoint":
        return ProjectivePoint(curve, 0, 1, 0)

    def is_zero(self) -> bool:
        return self.z == 0

    def to_affine(self) -> AffinePoint:
        if self.is_zero():
            return AffinePoint(self.curve, 0, 0, zero=True)
        p = self.curve.p
        z_inv = pow(self.z, -1, p)
        return AffinePoint(self.curve, self.x * z_inv % p,
                           self.y * z_inv % p)

    def double(self) -> "ProjectivePoint":
        if self.is_zero():
            return self
        p = self.curve.p
        x, y, z = self.x, self.y, self.z
        # homogeneous doubling for a=0 curves and general a
        a = self.curve.a
        w = (a * z * z + 3 * x * x) % p
        s = y * z % p
        b = x * y % p * s % p
        h = (w * w - 8 * b) % p
        x3 = 2 * h * s % p
        y3 = (w * (4 * b - h) - 8 * y * y % p * s % p * s % p) % p
        z3 = 8 * s * s % p * s % p
        return ProjectivePoint(self.curve, x3, y3, z3)

    def __add__(self, other: "ProjectivePoint") -> "ProjectivePoint":
        if self.is_zero():
            return other
        if other.is_zero():
            return self
        p = self.curve.p
        x1, y1, z1 = self.x, self.y, self.z
        x2, y2, z2 = other.x, other.y, other.z
        u1 = y2 * z1 % p
        u2 = y1 * z2 % p
        v1 = x2 * z1 % p
        v2 = x1 * z2 % p
        if v1 == v2:
            if u1 == u2:
                return self.double()
            return ProjectivePoint.zero(self.curve)
        u = (u1 - u2) % p
        v = (v1 - v2) % p
        w = z1 * z2 % p
        a = (u * u % p * w - v ** 3 - 2 * v * v % p * v2) % p
        x3 = v * a % p
        y3 = (u * (v * v % p * v2 - a) - v ** 3 * u2) % p
        z3 = v ** 3 * w % p
        return ProjectivePoint(self.curve, x3, y3, z3)

    def mul(self, k: int) -> "ProjectivePoint":
        k %= self.curve.n
        result = ProjectivePoint.zero(self.curve)
        addend = self
        while k:
            if k & 1:
                result = result + addend
            addend = addend.double()
            k >>= 1
        return result


def generator(curve: CurveParams = SECP256K1) -> AffinePoint:
    return AffinePoint(curve, curve.gx, curve.gy)


def scalar_mul(p: AffinePoint, k: int) -> AffinePoint:
    return p.to_projective().mul(k).to_affine()


# -- GLV decomposition (reference curve/glv.rs:38-78) -------------------------

def decompose_secp256k1_scalar(k: int) -> Tuple[int, int, bool, bool]:
    """k = k1_raw + GLV_S * k2_raw with |k1|,|k2| < 2^128; returns
    (|k1|, |k2|, k1_neg, k2_neg)."""
    n = SECP256K1_N
    k %= n
    # c_i = round(b_i * k / n)
    c1 = (GLV_B2 * k + n // 2) // n
    c2 = (GLV_MINUS_B1 * k + n // 2) // n
    k1_raw = (k - c1 * GLV_A1 - c2 * GLV_A2) % n
    k2_raw = (c1 * GLV_MINUS_B1 - c2 * GLV_B2) % n
    if (k1_raw + GLV_S * k2_raw) % n != k:
        raise ArithmeticError("GLV decomposition does not recompose")

    half = n // 2
    k1_neg = k1_raw > half
    k1 = n - k1_raw if k1_neg else k1_raw
    k2_neg = k2_raw > half
    k2 = n - k2_raw if k2_neg else k2_raw
    if k1 >= 1 << 128 or k2 >= 1 << 128:
        raise ArithmeticError("GLV decomposition out of range")
    return k1, k2, k1_neg, k2_neg


def glv_mul(p: AffinePoint, k: int) -> AffinePoint:
    """k*P via the GLV endomorphism phi(x,y) = (beta*x, y)."""
    k1, k2, k1_neg, k2_neg = decompose_secp256k1_scalar(k)
    curve = p.curve
    sp = AffinePoint(curve, p.x * GLV_BETA % curve.p, p.y)
    p_adj = p.neg() if k1_neg else p
    sp_adj = sp.neg() if k2_neg else sp
    return (p_adj.to_projective().mul(k1)
            + sp_adj.to_projective().mul(k2)).to_affine()


# -- windowed MSM (reference curve/curve_msm.rs) ------------------------------

def curve_msm(points: List[AffinePoint], scalars: List[int],
              window_bits: int = 4) -> AffinePoint:
    """sum_i scalars[i] * points[i] with shared-window Straus MSM."""
    if len(points) != len(scalars):
        raise ValueError("one scalar a point")
    curve = points[0].curve
    max_bits = max((s.bit_length() for s in scalars), default=1)
    num_windows = -(-max_bits // window_bits)
    tables = []
    for pt in points:
        proj = pt.to_projective()
        table = [ProjectivePoint.zero(curve)]
        for _ in range(1, 1 << window_bits):
            table.append(table[-1] + proj)
        tables.append(table)
    result = ProjectivePoint.zero(curve)
    mask = (1 << window_bits) - 1
    for w in range(num_windows - 1, -1, -1):
        for _ in range(window_bits):
            result = result.double()
        for table, s in zip(tables, scalars):
            digit = (s >> (w * window_bits)) & mask
            if digit:
                result = result + table[digit]
    return result.to_affine()


# -- native ECDSA (reference curve/ecdsa.rs) ----------------------------------

@dataclass(frozen=True)
class ECDSASignature:
    r: int
    s: int


def sign_message(msg: int, sk: int, k: Optional[int] = None) -> ECDSASignature:
    n = SECP256K1_N
    if k is None:
        import secrets
        k = 1 + secrets.randbelow(n - 1)
    g = generator()
    point = scalar_mul(g, k)
    r = point.x % n
    if r == 0:
        raise ValueError("the nonce gives r = 0")
    s = pow(k, -1, n) * (msg + r * sk) % n
    if s == 0:
        raise ValueError("the nonce gives s = 0")
    return ECDSASignature(r=r, s=s)


def public_key(sk: int) -> AffinePoint:
    return scalar_mul(generator(), sk)


def ecrecover(msg: int, y_parity: int, r: int, s: int) -> AffinePoint:
    """Recover the signing public key from an ECDSA signature
    (Ethereum's ecrecover; reference kernel asm ecrecover.asm, spec'd by
    cpu/kernel/tests/ecrecover.rs).  `y_parity` is 0/1."""
    n, p = SECP256K1_N, SECP256K1_P
    # Ethereum pins the recovery x-coordinate to r itself and the recovery
    # id v in {27, 28} encodes only the y parity, so the "r + n overflow"
    # candidate (R.x = r + n < p) is NOT recoverable; signatures whose r
    # falls outside [1, n-1] are rejected outright (the kernel routine
    # secp_asm.py `ecrecover` enforces the same bounds with r < n / LT).
    if not (0 < r < n and 0 < s < n):
        raise ValueError("r or s out of [1, n - 1]")
    x = r
    y2 = (pow(x, 3, p) + SECP256K1_B) % p
    y = pow(y2, (p + 1) // 4, p)            # p % 4 == 3
    if y * y % p != y2:
        raise ValueError("r is not an x-coordinate on the curve")
    if y % 2 != y_parity:
        y = p - y
    R = AffinePoint(SECP256K1, x, y)
    rinv = pow(r, n - 2, n)
    u1 = (-msg * rinv) % n
    u2 = (s * rinv) % n
    q = (scalar_mul(generator(), u1).to_projective()
         + scalar_mul(R, u2).to_projective()).to_affine()
    if q.zero or not q.is_valid():
        raise ValueError("the signature recovers no key")
    return q


def verify_message(msg: int, sig: ECDSASignature, pk: AffinePoint) -> bool:
    n = SECP256K1_N
    r, s = sig.r, sig.s
    if not (0 < r < n and 0 < s < n):
        return False
    if not pk.is_valid():
        return False
    c = pow(s, -1, n)
    u1 = msg * c % n
    u2 = r * c % n
    point = (scalar_mul(generator(), u1).to_projective()
             + glv_mul(pk, u2).to_projective()).to_affine()
    return point.x % n == r
