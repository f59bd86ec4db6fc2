"""The port's big-integer and non-native field gadgets, and its secp256k1
and extension-tower fields, against the JAX package's, on the CPU.

- field/secp256k1.py: the constants and the scalar helpers equal JAX's
  on seeded values.
- field/extension_towers.py: every tower's constants equal JAX's and
  hold (tests/test_extension_towers.py's checks); add, mul, exp,
  inverse and Frobenius equal JAX's on seeded elements and satisfy the
  field axioms; the quadratic tower equals the port's field/extension.py.
- gadgets/biguint.py and gadgets/nonnative.py: the circuits of
  tests/test_u32_biguint.py::test_biguint_mul_div_cmp and
  test_nonnative_field_ops, written once and built by both packages
  from the same random.Random(0xBEEF) draws: the gates, the circuit
  digest and the host engine's witness equal JAX's; the port's CPU
  proof serializes byte for byte like JAX's under the same witness
  randomness, and the port's verifier accepts it; a wrong constant is
  refused in the witness.

Exact equality (field elements, ints and bytes).
"""
import random
import types

import numpy as np
import pytest

import plonky2_tpu.field.extension_towers as jet
import plonky2_tpu.field.secp256k1 as jsecp
from plonky2_tpu.ecdsa import curve as jcurve
from plonky2_tpu.gadgets import biguint as jbig
from plonky2_tpu.iop.generator import generate_partial_witness as jax_witness
from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu.utils.serialization import serialize_proof as jax_serialize
from plonky2_tpu_torch.ecdsa import curve
from plonky2_tpu_torch.field import extension as ext
from plonky2_tpu_torch.field import extension_towers as et
from plonky2_tpu_torch.field import secp256k1 as secp
from plonky2_tpu_torch.gadgets import biguint
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import P, pin_randomness

JAX = types.SimpleNamespace(builder=JaxBuilder, config=JaxCircuitConfig,
                            pw=JaxPartialWitness, curve=jcurve, big=jbig)
PORT = types.SimpleNamespace(builder=CircuitBuilder, config=CircuitConfig,
                             pw=PartialWitness, curve=curve, big=biguint)


# -- fields -------------------------------------------------------------

def test_secp256k1_fields_equal_jax():
    names = [n for n in dir(jsecp) if n.isupper()]
    assert names and [getattr(secp, n) for n in names] == \
        [getattr(jsecp, n) for n in names]
    assert secp.SECP256K1_BASE_ORDER == curve.SECP256K1_P
    assert secp.SECP256K1_SCALAR_ORDER == curve.SECP256K1_N
    rng = random.Random(0x5EC)
    for _ in range(20):
        a, b = rng.randrange(1 << 256), rng.randrange(1, 1 << 256)
        for f in ("base_add", "base_mul", "scalar_add", "scalar_mul"):
            assert getattr(secp, f)(a, b) == getattr(jsecp, f)(a, b), f
        for f in ("base_to_scalar", "scalar_to_base"):
            assert getattr(secp, f)(a) == getattr(jsecp, f)(a), f
        x = b % secp.SECP256K1_BASE_ORDER or 1
        y = b % secp.SECP256K1_SCALAR_ORDER or 1
        assert secp.base_inverse(x) == jsecp.base_inverse(x)
        assert secp.base_mul(x, secp.base_inverse(x)) == 1
        assert secp.scalar_inverse(y) == jsecp.scalar_inverse(y)
    for order, g, adicity in (
            (secp.SECP256K1_BASE_ORDER,
             secp.BASE_MULTIPLICATIVE_GROUP_GENERATOR, secp.BASE_TWO_ADICITY),
            (secp.SECP256K1_SCALAR_ORDER,
             secp.SCALAR_MULTIPLICATIVE_GROUP_GENERATOR,
             secp.SCALAR_TWO_ADICITY)):
        assert (order - 1) % (1 << adicity) == 0
        assert ((order - 1) >> adicity) % 2 == 1
        assert pow(g, (order - 1) // 2, order) == order - 1   # a non-square


def _rand_elem(rng, params):
    return tuple(rng.randrange(P) for _ in range(params.d))


@pytest.mark.parametrize("d", [2, 4, 5])
def test_tower_constants_equal_jax(d):
    params = et.TOWERS[d]
    assert params == et.ExtensionParams(**vars(jet.TOWERS[d]))
    # tests/test_extension_towers.py:19-38
    assert params.dth_root == pow(params.w, (P - 1) // d, P)
    assert pow(params.dth_root, d, P) == 1 and params.dth_root != 1
    g, order = params.ext_multiplicative_group_generator, P ** d - 1
    for q in [2, 3, 5, 7, 11, 13, 17, 257, 65537]:
        if order % q == 0:
            assert et.exp(params, g, order // q) != et.one(params), q
    adicity = {2: 33, 4: 34, 5: 32}[d]
    t = params.ext_power_of_two_generator
    assert et.exp(params, t, 1 << adicity) == et.one(params)
    assert et.exp(params, t, 1 << (adicity - 1)) != et.one(params)


@pytest.mark.parametrize("d", [2, 4, 5])
def test_tower_arithmetic_equals_jax(d):
    params, jparams = et.TOWERS[d], jet.TOWERS[d]
    rng = random.Random(0xE47 + d)
    for _ in range(10):
        a, b, c = (_rand_elem(rng, params) for _ in range(3))
        e = rng.randrange(1 << 64)
        for f, args in (("add", (a, b)), ("sub", (a, b)), ("neg", (a,)),
                        ("mul", (a, b)), ("scalar_mul", (a, e % P)),
                        ("exp", (a, e)), ("inverse", (a,)),
                        ("frobenius", (a,)), ("frobenius", (a, 3))):
            assert getattr(et, f)(params, *args) == \
                getattr(jet, f)(jparams, *args), f
        assert et.mul(params, et.mul(params, a, b), c) == \
            et.mul(params, a, et.mul(params, b, c))
        assert et.mul(params, a, et.add(params, b, c)) == \
            et.add(params, et.mul(params, a, b), et.mul(params, a, c))
        assert et.mul(params, a, et.inverse(params, a)) == et.one(params)
        assert et.frobenius(params, a) == et.exp(params, a, P)
    assert et.from_base(params, P + 5) == jet.from_base(jparams, P + 5)
    with pytest.raises(ZeroDivisionError):
        et.inverse(params, et.zero(params))


def test_quadratic_tower_equals_extension():
    """tests/test_extension_towers.py:56 on the port: the D=2 tower is
    the prover's field/extension.py."""
    rng = random.Random(0xE42)
    for _ in range(20):
        a, b = (_rand_elem(rng, et.QUADRATIC) for _ in range(2))
        assert et.mul(et.QUADRATIC, a, b) == ext.s_mul(a, b)
        assert et.inverse(et.QUADRATIC, a) == ext.s_inv(a)


# -- circuits -----------------------------------------------------------

def case_biguint(b, pw, rng, pkg):
    """tests/test_u32_biguint.py:58-84."""
    x = rng.randrange(1 << 128)
    y = rng.randrange(1, 1 << 96)
    xt = b.add_virtual_biguint_target(4)
    yt = b.add_virtual_biguint_target(3)
    pkg.big.set_biguint_target(pw, xt, x)
    pkg.big.set_biguint_target(pw, yt, y)
    b.connect_biguint(b.mul_biguint(xt, yt), b.constant_biguint(x * y))
    b.connect_biguint(b.add_biguint(xt, yt), b.constant_biguint(x + y))
    d = b.sub_biguint(xt, yt) if x >= y else b.sub_biguint(yt, xt)
    b.connect_biguint(d, b.constant_biguint(abs(x - y)))
    div, rem = b.div_rem_biguint(xt, yt)
    b.connect_biguint(div, b.constant_biguint(x // y))
    b.connect_biguint(rem, b.constant_biguint(x % y))
    b.connect(b.cmp_biguint(xt, yt), b.constant(int(x <= y)))


def case_nonnative(b, pw, rng, pkg, wrong=0):
    """tests/test_u32_biguint.py:87-114; with `wrong`, the sum's
    constant is off by it."""
    p = pkg.curve.SECP256K1_P
    x = rng.randrange(p)
    y = rng.randrange(1, p)
    xt = b.constant_nonnative(x, p)
    yt = b.constant_nonnative(y, p)
    b.connect_nonnative(b.add_nonnative(xt, yt),
                        b.constant_nonnative((x + y + wrong) % p, p))
    b.connect_nonnative(b.sub_nonnative(xt, yt),
                        b.constant_nonnative((x - y) % p, p))
    b.connect_nonnative(b.mul_nonnative(xt, yt),
                        b.constant_nonnative(x * y % p, p))
    b.connect_nonnative(b.inv_nonnative(yt),
                        b.constant_nonnative(pow(y, -1, p), p))
    b.connect_nonnative(b.neg_nonnative(xt),
                        b.constant_nonnative((-x) % p, p))
    b.connect_nonnative(b.add_many_nonnative([xt, yt, xt]),
                        b.constant_nonnative((2 * x + y) % p, p))


def build(pkg, case, seed, config="standard_ecc_config", **kw):
    """`case` on `pkg`'s builder from random.Random(seed): (the builder,
    CircuitData (the port's built on the CPU), PartialWitness)."""
    b, pw = pkg.builder(getattr(pkg.config, config)()), pkg.pw()
    case(b, pw, random.Random(seed), pkg, **kw)
    return b, (b.build(device="cpu") if pkg is PORT else b.build()), pw


def same_placement(b, jb):
    """Gate instances (ids and constants), copy constraints and the
    generators' kinds, in order, equal the JAX builder's."""
    assert [(i.gate.id(), [int(c) for c in i.constants])
            for i in b.gate_instances] == \
        [(i.gate.id(), [int(c) for c in i.constants])
         for i in jb.gate_instances]
    assert b.copy_constraints == jb.copy_constraints
    assert [type(g).__name__ for g in b.generators] == \
        [type(g).__name__ for g in jb.generators]


def same_circuit(td, jd):
    assert [g.id() for g in td.common.gates] == \
        [g.id() for g in jd.common.gates]
    assert td.common.degree_bits() == jd.common.degree_bits()
    assert [int(x) for x in td.verifier_only.circuit_digest] == \
        [int(x) for x in jd.verifier_only.circuit_digest]


def check_circuit_equals_jax(monkeypatch, case, seed):
    """Both builds, the witness and the proof (the module docstring)."""
    b, td, tpw = build(PORT, case, seed)
    jb, jd, jpw = build(JAX, case, seed)
    same_placement(b, jb)
    same_circuit(td, jd)
    restart = pin_randomness(monkeypatch, seed)
    want = jax_witness(jpw, jd.prover_only, jd.common).full_witness()
    got = generate_partial_witness(tpw, td.prover_only, td.common,
                                   rng=random.Random(seed))
    np.testing.assert_array_equal(got.full_witness(), want)
    restart()
    proof = ProverSession(td, "cpu").prove(tpw, rng=random.Random(seed))
    restart()
    assert serialize_proof(proof) == jax_serialize(jd.prove(jpw))
    td.verify(proof)
    return td


@pytest.mark.parametrize("case", [case_biguint, case_nonnative],
                         ids=["biguint mul div cmp", "nonnative field ops"])
def test_gadget_circuit_equals_jax(monkeypatch, case):
    check_circuit_equals_jax(monkeypatch, case, 0xBEEF)


def test_wrong_nonnative_sum_refused():
    _, td, tpw = build(PORT, case_nonnative, 0xBEEF, wrong=1)
    with pytest.raises(ValueError, match="set twice with different values"):
        generate_partial_witness(tpw, td.prover_only, td.common,
                                 rng=random.Random(0))


def test_biguint_helpers_equal_jax():
    rng = random.Random(0xB16)
    for bits in (0, 1, 31, 32, 33, 64, 255, 256, 300):
        v = rng.randrange(1 << bits) if bits else 0
        assert biguint.to_u32_digits(v) == jbig.to_u32_digits(v)
    b = CircuitBuilder(CircuitConfig.standard_ecc_config())
    t = b.add_virtual_biguint_target(2)
    pw = PartialWitness()
    with pytest.raises(ValueError, match="does not fit"):
        biguint.set_biguint_target(pw, t, 1 << 64)
    biguint.set_biguint_target(pw, t, 5)
    assert [pw.target_values[x] for x in t.limbs] == [5, 0]
