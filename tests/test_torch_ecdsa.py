"""The port's secp256k1 curve (ecdsa/curve.py) and its curve gadgets and
ECDSA verification circuit (ecdsa/gadgets.py, models/ecdsa_verify.py)
against the JAX package's, on the CPU.

- The native curve: on seeded scalars, points, keys and messages,
  scalar_mul, glv_mul, curve_msm, decompose_secp256k1_scalar,
  sign_message, verify_message and ecrecover equal JAX's; the offset
  point of the circuits is JAX's.
- The circuits of the three non-heavy tests of tests/test_ecdsa_gadgets.py
  (add, double and neg of points, the conditional add and neg, random
  access of points), in one circuit from random.Random(0x5EC9) draws:
  gates, circuit digest and witness equal JAX's, the port's CPU proof is
  JAX's byte for byte and its verifier accepts it.
- The full ECDSA circuit (tests/test_ecdsa_verify.py, 98,660 gates),
  without a build: both builders place the same gate instances, copy
  constraints and generators.  ``heavy`` (RUN_HEAVY_TESTS=1): both
  packages build it (2^17 rows, equal digests), the port proves it on
  the CPU and verifies it, and its host witness refuses s + 1 mod n.

Exact equality (ints, field elements and bytes).
"""
import random

import pytest

from plonky2_tpu.ecdsa import curve as jcv
from plonky2_tpu.ecdsa import gadgets as jgd
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu_torch.ecdsa import curve as cv
from plonky2_tpu_torch.ecdsa import gadgets as gd
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.models import ecdsa_verify
from tests.test_torch_biguint_nonnative import (check_circuit_equals_jax,
                                                same_circuit, same_placement)
from tests.test_torch_prover import one_torch_thread  # noqa: F401

N = cv.SECP256K1_N


def jax_point(p):
    return jcv.AffinePoint(jcv.SECP256K1, p.x, p.y, p.zero)


def key(p):
    return (p.x, p.y, p.zero)


def test_curve_constants_equal_jax():
    names = [n for n in dir(jcv) if n.isupper() and n != "SECP256K1"]
    assert [getattr(cv, n) for n in names] == [getattr(jcv, n)
                                               for n in names]
    assert vars(cv.SECP256K1) == vars(jcv.SECP256K1)
    assert key(gd._rando()) == key(jgd._rando())
    assert gd.RANDO_TAG == b"plonky2_tpu/ecdsa rando"


def test_native_curve_equals_jax():
    rng = random.Random(0xC0DE)
    g, jg = cv.generator(), jcv.generator()
    for _ in range(4):
        k = rng.randrange(1, N)
        p = cv.scalar_mul(g, k)
        assert key(p) == key(jcv.scalar_mul(jg, k))
        assert p.is_valid()
        s = rng.randrange(1 << 256)
        assert key(cv.glv_mul(p, s)) == key(jcv.glv_mul(jax_point(p), s))
        assert key(cv.glv_mul(p, s)) == key(cv.scalar_mul(p, s))
        assert cv.decompose_secp256k1_scalar(s) == \
            jcv.decompose_secp256k1_scalar(s)
        assert key(p.double()) == key(jax_point(p).double())
        assert key(p + g) == key(jax_point(p) + jg)
        assert key(-p) == key(-jax_point(p))
    points = [cv.scalar_mul(g, rng.randrange(1, N)) for _ in range(3)]
    scalars = [rng.randrange(1 << 256) for _ in range(3)]
    got = cv.curve_msm(points, scalars)
    assert key(got) == key(jcv.curve_msm([jax_point(p) for p in points],
                                         scalars))
    want = cv.ProjectivePoint.zero(cv.SECP256K1)
    for p, s in zip(points, scalars):
        want = want + p.to_projective().mul(s)
    assert key(got) == key(want.to_affine())


def test_ecdsa_native_equals_jax():
    rng = random.Random(0xEC)
    for _ in range(3):
        msg, sk, k = (rng.randrange(1, N) for _ in range(3))
        sig = cv.sign_message(msg, sk, k=k)
        jsig = jcv.sign_message(msg, sk, k=k)
        assert (sig.r, sig.s) == (jsig.r, jsig.s)
        pk = cv.public_key(sk)
        assert key(pk) == key(jcv.public_key(sk))
        assert cv.verify_message(msg, sig, pk)
        assert jcv.verify_message(msg, jsig, jax_point(pk))
        bad = cv.ECDSASignature(sig.r, (sig.s + 1) % N)
        assert not cv.verify_message(msg, bad, pk)
        assert not jcv.verify_message(msg, jcv.ECDSASignature(bad.r, bad.s),
                                      jax_point(pk))
        r_point = cv.scalar_mul(cv.generator(), k)
        parity = r_point.y % 2
        if r_point.x < N:
            got = cv.ecrecover(msg, parity, sig.r, sig.s)
            assert key(got) == key(pk) == \
                key(jcv.ecrecover(msg, parity, sig.r, sig.s))
    with pytest.raises(ValueError, match="out of"):
        cv.ecrecover(1, 0, 0, 1)


# -- tests/test_ecdsa_gadgets.py's circuits -----------------------------

def _rand_point(pkg, rng):
    return pkg.curve.scalar_mul(pkg.curve.generator(),
                                rng.randrange(1, pkg.curve.SECP256K1_N))


def case_add_double(b, pw, rng, pkg):
    p, q = _rand_point(pkg, rng), _rand_point(pkg, rng)
    pt, qt = b.constant_affine_point(p), b.constant_affine_point(q)
    b.curve_assert_valid(pt)
    b.curve_assert_valid(qt)
    b.connect_affine_point(b.curve_add(pt, qt),
                           b.constant_affine_point(p.add(q)))
    b.connect_affine_point(b.curve_double(pt),
                           b.constant_affine_point(p.double()))
    b.connect_affine_point(b.curve_neg(pt), b.constant_affine_point(p.neg()))


def case_conditional(b, pw, rng, pkg):
    p, q = _rand_point(pkg, rng), _rand_point(pkg, rng)
    pt, qt = b.constant_affine_point(p), b.constant_affine_point(q)
    one, zero = b.one(), b.zero()
    b.connect_affine_point(b.curve_conditional_add(pt, qt, one),
                           b.constant_affine_point(p.add(q)))
    b.connect_affine_point(b.curve_conditional_add(pt, qt, zero), pt)
    b.connect_affine_point(b.curve_conditional_neg(pt, one),
                           b.constant_affine_point(p.neg()))


def case_random_access(b, pw, rng, pkg):
    pts = [b.constant_affine_point(_rand_point(pkg, rng)) for _ in range(8)]
    i = rng.randrange(8)
    b.connect_affine_point(b.random_access_curve_points(b.constant(i), pts),
                           pts[i])


def case_curve_tests(b, pw, rng, pkg):
    """The three tests' circuits one after another in one circuit (1,642
    gates, 2^11 rows, as many as the first alone): one build, witness and
    proof a package instead of three."""
    for case in (case_add_double, case_conditional, case_random_access):
        case(b, pw, rng, pkg)


def test_curve_circuit_equals_jax(monkeypatch):
    td = check_circuit_equals_jax(monkeypatch, case_curve_tests, 0x5EC9)
    assert td.common.degree_bits() == 11
    names = {type(g).__name__ for g in td.common.gates}
    assert {"U32ArithmeticGate", "U32AddManyGate", "U32SubtractionGate",
            "ComparisonGate", "U32RangeCheckGate",
            "RandomAccessGate"} <= names


# -- the ECDSA circuit --------------------------------------------------

def test_ecdsa_inputs_equal_jax_test():
    """models/ecdsa_verify.py draws tests/test_ecdsa_verify.py's
    message, key and nonce, in its order."""
    rng = random.Random(ecdsa_verify.SEED)
    msg, sk = rng.randrange(N), rng.randrange(1, N)
    sig = jcv.sign_message(msg, sk, k=rng.randrange(1, N))
    got = ecdsa_verify.ecdsa_inputs(cv)
    assert (got.msg, key(got.pk), got.sig.r, got.sig.s) == \
        (msg, key(jcv.public_key(sk)), sig.r, sig.s)
    assert cv.verify_message(got.msg, got.sig, got.pk)
    bad = ecdsa_verify.ecdsa_inputs(cv, wrong_signature=True)
    assert bad.sig.s == (sig.s + 1) % N
    assert not cv.verify_message(bad.msg, bad.sig, bad.pk)


def jax_ecdsa_builder(wrong_signature=False):
    b = JaxBuilder(JaxCircuitConfig.standard_ecc_config())
    ecdsa_verify.place_ecdsa_verify(
        b, jcv, jgd, ecdsa_verify.ecdsa_inputs(jcv, wrong_signature=
                                               wrong_signature))
    return b


def test_ecdsa_circuit_placement_equals_jax():
    b, _ = ecdsa_verify.ecdsa_builder()
    assert b.num_gates() == ecdsa_verify.GATES
    same_placement(b, jax_ecdsa_builder())


@pytest.mark.heavy
def test_ecdsa_circuit_proof():
    """tests/test_ecdsa_verify.py on the port, on the CPU: both packages
    build the circuit (equal digests, 2^17 rows), the port proves and
    verifies it, and a wrong signature is refused in the witness."""
    data, pw, _ = ecdsa_verify.build_ecdsa_circuit(device="cpu")
    assert data.common.degree_bits() == ecdsa_verify.LOG_N
    same_circuit(data, jax_ecdsa_builder().build())
    from plonky2_tpu_torch.runtime.session import ProverSession
    sess = ProverSession(data, "cpu")
    sess.verify(sess.prove(pw, rng=random.Random(0)))
    bad, bad_pw, _ = ecdsa_verify.build_ecdsa_circuit(device="cpu",
                                                      wrong_signature=True)
    with pytest.raises(ValueError, match="set twice with different values"):
        generate_partial_witness(bad_pw, bad.prover_only, bad.common,
                                 rng=random.Random(0))
