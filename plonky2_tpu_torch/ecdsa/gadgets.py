"""secp256k1 curve arithmetic and ECDSA verification in a circuit: the
port's copy of plonky2_tpu/ecdsa/gadgets.py (reference ecdsa/src/gadgets/
{curve,curve_fixed_base,curve_windowed_mul,curve_msm,glv,split_nonnative,
ecdsa}.rs).

The group law is the incomplete affine one (the points nonzero and
distinct where it needs them); a fixed nothing-up-my-sleeve offset point
keeps the sums away from zero, as in the reference, which derives its
point from Keccak(0) (curve_msm.rs:33-38).  The offset point here is the
JAX package's: the same tag hashed with SHA3-256, so that both packages
build the same circuits.
"""
from __future__ import annotations

import functools
import hashlib
from dataclasses import dataclass
from typing import List

from ..gadgets.biguint import BigUintTarget, emit_biguint, get_biguint
from ..gadgets.nonnative import NonNativeTarget
from ..iop.generator import SimpleGenerator
from ..iop.target import Target
from . import curve as cv

WINDOW_SIZE = 4


# the offset point's tag: the JAX package's, so that the circuits agree
RANDO_TAG = b"plonky2_tpu/ecdsa rando"


@functools.lru_cache(maxsize=None)
def _rando() -> cv.AffinePoint:
    """The offset point: the generator times SHA3-256(RANDO_TAG) read
    little-endian, mod n."""
    seed = int.from_bytes(hashlib.sha3_256(RANDO_TAG).digest(),
                          "little") % cv.SECP256K1_N
    return cv.scalar_mul(cv.generator(), seed)


@dataclass
class AffinePointTarget:
    x: NonNativeTarget
    y: NonNativeTarget

    def to_vec(self):
        return [self.x, self.y]


class _GLVDecompositionGenerator(SimpleGenerator):
    def __init__(self, k, k1, k2, k1_neg, k2_neg):
        self.k, self.k1, self.k2 = k, k1, k2
        self.k1_neg, self.k2_neg = k1_neg, k2_neg

    def dependencies(self):
        return list(self.k.value.limbs)

    def run_once(self, witness, out):
        k = get_biguint(witness, self.k.value) % cv.SECP256K1_N
        k1, k2, k1_neg, k2_neg = cv.decompose_secp256k1_scalar(k)
        emit_biguint(out, self.k1.value, k1)
        emit_biguint(out, self.k2.value, k2)
        out.append((self.k1_neg, int(k1_neg)))
        out.append((self.k2_neg, int(k2_neg)))


class CurveGadgets:
    """Mixed into CircuitBuilder.  All points are secp256k1 unless a curve is
    passed explicitly."""

    # -- point plumbing ------------------------------------------------------

    def constant_affine_point(self,
                              point: cv.AffinePoint) -> AffinePointTarget:
        if point.zero:
            raise ValueError("the point at infinity has no affine target")
        p = point.curve.p
        return AffinePointTarget(x=self.constant_nonnative(point.x, p),
                                 y=self.constant_nonnative(point.y, p))

    def connect_affine_point(self, lhs: AffinePointTarget,
                             rhs: AffinePointTarget) -> None:
        self.connect_nonnative(lhs.x, rhs.x)
        self.connect_nonnative(lhs.y, rhs.y)

    def add_virtual_affine_point_target(self, curve=cv.SECP256K1
                                        ) -> AffinePointTarget:
        return AffinePointTarget(x=self.add_virtual_nonnative_target(curve.p),
                                 y=self.add_virtual_nonnative_target(curve.p))

    def curve_assert_valid(self, p: AffinePointTarget,
                           curve=cv.SECP256K1) -> None:
        a = self.constant_nonnative(curve.a, curve.p)
        b = self.constant_nonnative(curve.b, curve.p)
        y_squared = self.mul_nonnative(p.y, p.y)
        x_squared = self.mul_nonnative(p.x, p.x)
        x_cubed = self.mul_nonnative(x_squared, p.x)
        a_x = self.mul_nonnative(a, p.x)
        a_x_plus_b = self.add_nonnative(a_x, b)
        rhs = self.add_nonnative(x_cubed, a_x_plus_b)
        self.connect_nonnative(y_squared, rhs)

    def curve_neg(self, p: AffinePointTarget) -> AffinePointTarget:
        return AffinePointTarget(x=p.x, y=self.neg_nonnative(p.y))

    def curve_conditional_neg(self, p: AffinePointTarget,
                              b: Target) -> AffinePointTarget:
        return AffinePointTarget(x=p.x,
                                 y=self.nonnative_conditional_neg(p.y, b))

    # -- incomplete group law ------------------------------------------------

    def curve_double(self, p: AffinePointTarget,
                     curve=cv.SECP256K1) -> AffinePointTarget:
        x, y = p.x, p.y
        double_y = self.add_nonnative(y, y)
        inv_double_y = self.inv_nonnative(double_y)
        x_squared = self.mul_nonnative(x, x)
        double_x_squared = self.add_nonnative(x_squared, x_squared)
        triple_x_squared = self.add_nonnative(double_x_squared, x_squared)
        a = self.constant_nonnative(curve.a, curve.p)
        triple_xx_a = self.add_nonnative(triple_x_squared, a)
        lam = self.mul_nonnative(triple_xx_a, inv_double_y)
        lam_squared = self.mul_nonnative(lam, lam)
        x_double = self.add_nonnative(x, x)
        x3 = self.sub_nonnative(lam_squared, x_double)
        x_diff = self.sub_nonnative(x, x3)
        lam_x_diff = self.mul_nonnative(lam, x_diff)
        y3 = self.sub_nonnative(lam_x_diff, y)
        return AffinePointTarget(x=x3, y=y3)

    def curve_repeated_double(self, p: AffinePointTarget,
                              n: int) -> AffinePointTarget:
        for _ in range(n):
            p = self.curve_double(p)
        return p

    def curve_add(self, p1: AffinePointTarget,
                  p2: AffinePointTarget) -> AffinePointTarget:
        """Incomplete addition: assumes p1 != +-p2 and both nonzero."""
        x1, y1 = p1.x, p1.y
        x2, y2 = p2.x, p2.y
        u = self.sub_nonnative(y2, y1)
        v = self.sub_nonnative(x2, x1)
        v_inv = self.inv_nonnative(v)
        s = self.mul_nonnative(u, v_inv)
        s_squared = self.mul_nonnative(s, s)
        x_sum = self.add_nonnative(x2, x1)
        x3 = self.sub_nonnative(s_squared, x_sum)
        x_diff = self.sub_nonnative(x1, x3)
        prod = self.mul_nonnative(s, x_diff)
        y3 = self.sub_nonnative(prod, y1)
        return AffinePointTarget(x=x3, y=y3)

    def curve_conditional_add(self, p1: AffinePointTarget,
                              p2: AffinePointTarget,
                              b: Target) -> AffinePointTarget:
        not_b = self.not_(b)
        s = self.curve_add(p1, p2)
        x_if_true = self.mul_nonnative_by_bool(s.x, b)
        y_if_true = self.mul_nonnative_by_bool(s.y, b)
        x_if_false = self.mul_nonnative_by_bool(p1.x, not_b)
        y_if_false = self.mul_nonnative_by_bool(p1.y, not_b)
        return AffinePointTarget(x=self.add_nonnative(x_if_true, x_if_false),
                                 y=self.add_nonnative(y_if_true, y_if_false))

    # -- scalar multiplication, bit-serial (reference curve.rs:216-255) ------

    def curve_scalar_mul(self, p: AffinePointTarget,
                         n: NonNativeTarget) -> AffinePointTarget:
        bits = self.split_nonnative_to_bits(n)
        rando = _rando()
        randot = self.constant_affine_point(rando)
        result = self.add_virtual_affine_point_target()
        self.connect_affine_point(randot, result)
        two_i_times_p = self.add_virtual_affine_point_target()
        self.connect_affine_point(p, two_i_times_p)

        for bit in bits:
            not_bit = self.not_(bit)
            result_plus = self.curve_add(result, two_i_times_p)
            new_x_t = self.mul_nonnative_by_bool(result_plus.x, bit)
            new_x_f = self.mul_nonnative_by_bool(result.x, not_bit)
            new_y_t = self.mul_nonnative_by_bool(result_plus.y, bit)
            new_y_f = self.mul_nonnative_by_bool(result.y, not_bit)
            result = AffinePointTarget(x=self.add_nonnative(new_x_t, new_x_f),
                                       y=self.add_nonnative(new_y_t, new_y_f))
            two_i_times_p = self.curve_double(two_i_times_p)

        neg_r = self.curve_neg(randot)
        return self.curve_add(result, neg_r)

    # -- limb splits (reference split_nonnative.rs) --------------------------

    def split_u32_to_4_bit_limbs(self, val: Target) -> List[Target]:
        two_bit_limbs = self.split_le_base(val, 16, 4)
        four = self.constant(4)
        return [self.mul_add(b, four, a)
                for a, b in zip(two_bit_limbs[0::2], two_bit_limbs[1::2])]

    def split_nonnative_to_4_bit_limbs(self,
                                       val: NonNativeTarget) -> List[Target]:
        out = []
        for limb in val.value.limbs:
            out.extend(self.split_u32_to_4_bit_limbs(limb))
        return out

    def split_nonnative_to_2_bit_limbs(self,
                                       val: NonNativeTarget) -> List[Target]:
        out = []
        for limb in val.value.limbs:
            out.extend(self.split_le_base(limb, 16, 4))
        return out

    # -- windowed ops (reference curve_windowed_mul.rs) ----------------------

    def random_access_curve_points(self, access_index: Target,
                                   v: List[AffinePointTarget],
                                   curve=cv.SECP256K1) -> AffinePointTarget:
        num_limbs = -(-curve.p.bit_length() // 32)
        zero = self.zero_u32()
        sel_x, sel_y = [], []
        for i in range(num_limbs):
            xs = [p.x.value.limbs[i] if i < len(p.x.value.limbs) else zero
                  for p in v]
            ys = [p.y.value.limbs[i] if i < len(p.y.value.limbs) else zero
                  for p in v]
            sel_x.append(self.random_access(access_index, xs))
            sel_y.append(self.random_access(access_index, ys))
        return AffinePointTarget(
            x=NonNativeTarget(BigUintTarget(sel_x), curve.p),
            y=NonNativeTarget(BigUintTarget(sel_y), curve.p))

    def precompute_window(self,
                          p: AffinePointTarget) -> List[AffinePointTarget]:
        g = _rando()
        neg = self.constant_affine_point(g.neg())
        multiples = [self.constant_affine_point(g)]
        for i in range(1, 1 << WINDOW_SIZE):
            multiples.append(self.curve_add(p, multiples[i - 1]))
        for i in range(1, 1 << WINDOW_SIZE):
            multiples[i] = self.curve_add(neg, multiples[i])
        return multiples

    def curve_scalar_mul_windowed(self, p: AffinePointTarget,
                                  n: NonNativeTarget) -> AffinePointTarget:
        start = _rando()
        start_multiplied = start.to_projective()
        scalar_bits = 32 * len(n.value.limbs)
        for _ in range(scalar_bits):
            start_multiplied = start_multiplied.double()
        result = self.constant_affine_point(start)
        precomputation = self.precompute_window(p)
        zero = self.zero()
        windows = self.split_nonnative_to_4_bit_limbs(n)
        for window in reversed(windows):
            result = self.curve_repeated_double(result, WINDOW_SIZE)
            to_add = self.random_access_curve_points(window, precomputation)
            is_zero = self.is_equal(window, zero)
            should_add = self.not_(is_zero)
            result = self.curve_conditional_add(result, to_add, should_add)
        to_add = self.constant_affine_point(start_multiplied.to_affine().neg())
        return self.curve_add(result, to_add)

    # -- fixed-base mul (reference curve_fixed_base.rs) ----------------------

    def fixed_base_curve_mul(self, base: cv.AffinePoint,
                             scalar: NonNativeTarget) -> AffinePointTarget:
        """Windowed fixed-base scalar mul with a 4-bit window; the window
        tables are circuit constants."""
        num_windows = len(scalar.value.limbs) * 8
        scaled_base = []
        acc = base
        for _ in range(num_windows):
            scaled_base.append(acc)
            for _ in range(4):
                acc = acc.double()

        limbs = self.split_nonnative_to_4_bit_limbs(scalar)
        rando = _rando()
        zero = self.zero()
        result = self.constant_affine_point(rando)
        for limb, point in zip(limbs, scaled_base):
            # muls_point[t] = t * point for t=1..16; position 0 is a dummy
            # (guarded by the is_zero check)
            table_pts = []
            acc_p = cv.ProjectivePoint.zero(point.curve)
            for _ in range(16):
                acc_p = acc_p + point.to_projective()
                table_pts.append(acc_p.to_affine())
            muls_point = [self.constant_affine_point(q)
                          for q in table_pts[:15]]
            muls_point.insert(0, muls_point[0])
            is_zero = self.is_equal(limb, zero)
            should_add = self.not_(is_zero)
            r = self.random_access_curve_points(limb, muls_point)
            result = self.curve_conditional_add(result, r, should_add)

        to_add = self.constant_affine_point(rando.neg())
        return self.curve_add(result, to_add)

    # -- two-scalar MSM with 2-bit windows (reference curve_msm.rs) ----------

    def curve_msm(self, p: AffinePointTarget, q: AffinePointTarget,
                  n: NonNativeTarget, m: NonNativeTarget) -> AffinePointTarget:
        """n*p + m*q; doesn't work if p == q."""
        limbs_n = self.split_nonnative_to_2_bit_limbs(n)
        limbs_m = self.split_nonnative_to_2_bit_limbs(m)
        if len(limbs_n) != len(limbs_m):
            raise ValueError("scalars of unequal limb counts")
        num_limbs = len(limbs_n)

        rando = _rando()
        rando_t = self.constant_affine_point(rando)
        neg_rando = self.constant_affine_point(rando.neg())

        # precomputation[i + 4j] = i*p + j*q (offset by rando, then fixed)
        precomputation = [p] * 16
        cur_p = rando_t
        cur_q = rando_t
        for i in range(4):
            precomputation[i] = cur_p
            precomputation[4 * i] = cur_q
            cur_p = self.curve_add(cur_p, p)
            cur_q = self.curve_add(cur_q, q)
        for i in range(1, 4):
            precomputation[i] = self.curve_add(precomputation[i], neg_rando)
            precomputation[4 * i] = self.curve_add(precomputation[4 * i],
                                                   neg_rando)
        for i in range(1, 4):
            for j in range(1, 4):
                precomputation[i + 4 * j] = self.curve_add(
                    precomputation[i], precomputation[4 * j])

        four = self.constant(4)
        zero = self.zero()
        result = rando_t
        for limb_n, limb_m in reversed(list(zip(limbs_n, limbs_m))):
            result = self.curve_repeated_double(result, 2)
            index = self.mul_add(four, limb_m, limb_n)
            r = self.random_access_curve_points(index, precomputation)
            is_zero = self.is_equal(index, zero)
            should_add = self.not_(is_zero)
            result = self.curve_conditional_add(result, r, should_add)

        start_multiplied = rando
        for _ in range(2 * num_limbs):
            start_multiplied = start_multiplied.double()
        to_add = self.constant_affine_point(start_multiplied.neg())
        return self.curve_add(result, to_add)

    # -- GLV (reference gadgets/glv.rs) ---------------------------------------

    def glv_decompose(self, k: NonNativeTarget):
        n = cv.SECP256K1_N
        k1 = NonNativeTarget(self.add_virtual_biguint_target(4), n)
        k2 = NonNativeTarget(self.add_virtual_biguint_target(4), n)
        k1_neg = self.add_virtual_target()
        k2_neg = self.add_virtual_target()
        self.generators.append(
            _GLVDecompositionGenerator(k, k1, k2, k1_neg, k2_neg))
        self.assert_bool(k1_neg)
        self.assert_bool(k2_neg)
        self.range_check_u32(k1.value.limbs)
        self.range_check_u32(k2.value.limbs)

        # k1_raw + GLV_S * k2_raw == k
        k1_raw = self.nonnative_conditional_neg(k1, k1_neg)
        k2_raw = self.nonnative_conditional_neg(k2, k2_neg)
        s = self.constant_nonnative(cv.GLV_S, n)
        should_be_k = self.mul_nonnative(s, k2_raw)
        should_be_k = self.add_nonnative(should_be_k, k1_raw)
        self.connect_nonnative(should_be_k, k)
        return k1, k2, k1_neg, k2_neg

    def glv_mul(self, p: AffinePointTarget,
                k: NonNativeTarget) -> AffinePointTarget:
        k1, k2, k1_neg, k2_neg = self.glv_decompose(k)
        beta = self.constant_nonnative(cv.GLV_BETA, cv.SECP256K1_P)
        beta_px = self.mul_nonnative(beta, p.x)
        sp = AffinePointTarget(x=beta_px, y=p.y)
        p_neg = self.curve_conditional_neg(p, k1_neg)
        sp_neg = self.curve_conditional_neg(sp, k2_neg)
        return self.curve_msm(p_neg, sp_neg, k1, k2)


# -- ECDSA verification circuit (reference gadgets/ecdsa.rs) ------------------

@dataclass
class ECDSASignatureTarget:
    r: NonNativeTarget
    s: NonNativeTarget


@dataclass
class ECDSAPublicKeyTarget:
    point: AffinePointTarget


def verify_message_circuit(builder, msg: NonNativeTarget,
                           sig: ECDSASignatureTarget,
                           pk: ECDSAPublicKeyTarget) -> None:
    n = cv.SECP256K1_N
    builder.curve_assert_valid(pk.point)
    c = builder.inv_nonnative(sig.s)
    u1 = builder.mul_nonnative(msg, c)
    u2 = builder.mul_nonnative(sig.r, c)
    point1 = builder.fixed_base_curve_mul(cv.generator(), u1)
    point2 = builder.glv_mul(pk.point, u2)
    point = builder.curve_add(point1, point2)
    x = NonNativeTarget(value=point.x.value, modulus=n)
    builder.connect_nonnative(sig.r, x)
