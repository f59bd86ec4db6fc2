"""The port's gadgets against the JAX package's, on the CPU.

The port's versions of tests/test_gadgets.py: extension arithmetic,
division and exponentiation; split_le, le_sum, split_low_high, select,
is_equal and random access; the reducing factor on base and extension
terms; polynomial evaluation; coset interpolation of both kinds.  Each
case builds one circuit with the JAX builder and the same circuit with
the port's (the case is written once, against either package), then

- the gates equal JAX's, id for id;
- the host engine's witness (iop/generator.py, its randomness from one
  seeded stream) equals JAX's, wire for wire;
- every gate's filtered constraint vanishes on that witness, on every
  row (plonk/vanishing.py:evaluate_gate_constraints on NumpyBatch), and
  every value the case connects to a constant holds (the engine raises
  on a conflict).

Exact equality (field elements).
"""
import random
import types

import numpy as np
import pytest

import plonky2_tpu.gadgets.polynomial as jpoly
import plonky2_tpu.gadgets.reducing as jred
import plonky2_tpu.gates.interpolation as jint
from plonky2_tpu.field import extension as ge
from plonky2_tpu.field import goldilocks as gl
from plonky2_tpu.iop.generator import \
    generate_partial_witness as jax_generate
from plonky2_tpu.iop.witness import PartialWitness as JaxPartialWitness
from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JaxBuilder
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu_torch.field import fft
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.gadgets import polynomial, reducing
from plonky2_tpu_torch.gates import interpolation
from plonky2_tpu_torch.hash import poseidon as pos
from plonky2_tpu_torch.iop.generator import generate_partial_witness
from plonky2_tpu_torch.iop.witness import PartialWitness
from plonky2_tpu_torch.plonk.algebra import EvaluationVars, NumpyBatch
from plonky2_tpu_torch.plonk.circuit_builder import CircuitBuilder
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.plonk.vanishing import evaluate_gate_constraints
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_prover import pin_randomness

JAX = types.SimpleNamespace(
    builder=lambda: JaxBuilder(JaxCircuitConfig.standard_recursion_config()),
    pw=JaxPartialWitness, reducing=jred.ReducingFactorTarget,
    polynomial=jpoly.PolynomialCoeffsExtTarget, interpolant=jint.interpolant)
PORT = types.SimpleNamespace(
    builder=lambda: CircuitBuilder(CircuitConfig.standard_recursion_config()),
    pw=PartialWitness, reducing=reducing.ReducingFactorTarget,
    polynomial=polynomial.PolynomialCoeffsExtTarget,
    interpolant=interpolation.interpolant)


def case_extension_arithmetic(b, pw, rng, pkg):
    x, y = rng.ext(), rng.ext()
    xt = b.add_virtual_extension_target()
    yt = b.add_virtual_extension_target()
    pw.set_extension_target(xt, x)
    pw.set_extension_target(yt, y)
    cases = [
        (b.mul_extension(xt, yt), ge.s_mul(x, y)),
        (b.add_extension(xt, yt), ge.s_add(x, y)),
        (b.sub_extension(xt, yt), ge.s_sub(x, y)),
        (b.div_extension(xt, yt), ge.s_mul(x, ge.s_inv(y))),
        (b.inverse_extension(yt), ge.s_inv(y)),
        (b.exp_u64_extension(xt, 31337), ge.s_exp(x, 31337)),
        (b.exp_power_of_2_extension(xt, 5), ge.s_exp(x, 32)),
        (b.mul_add_extension(xt, yt, xt), ge.s_add(ge.s_mul(x, y), x)),
        (b.scalar_mul_ext(b.constant(7), yt), ge.s_mul((7, 0), y)),
    ]
    for target, expect in cases:
        b.connect_extension(target, b.constant_extension(expect))


def case_split_select_random_access(b, pw, rng, pkg):
    v = rng.below(1 << 52)
    vt = b.add_virtual_target()
    pw.set_target(vt, v)
    bits = b.split_le(vt, 52)
    b.connect(b.le_sum(bits), vt)
    b.connect(bits[3], b.constant((v >> 3) & 1))
    lo, hi = b.split_low_high(vt, 20, 52)
    b.connect(lo, b.constant(v & ((1 << 20) - 1)))
    b.connect(hi, b.constant(v >> 20))
    y = b.exp_u64(vt, 0x1234567)
    b.connect(y, b.constant(pow(v, 0x1234567, gl.P)))

    vec_vals = [rng.below(gl.P) for _ in range(16)]
    vec = [b.constant(c) for c in vec_vals]
    idx = rng.below(16)
    b.connect(b.random_access(b.constant(idx), vec),
              b.constant(vec_vals[idx]))
    ext_vals = [rng.ext() for _ in range(8)]
    ext_vec = [b.constant_extension(e) for e in ext_vals]
    eidx = rng.below(8)
    b.connect_extension(b.random_access_extension(b.constant(eidx), ext_vec),
                        b.constant_extension(ext_vals[eidx]))

    b.connect(b.select(b.one(), vec[0], vec[1]), vec[0])
    b.connect_extension(b.select_ext(b.zero(), ext_vec[0], ext_vec[1]),
                        ext_vec[1])
    b.connect(b.is_equal(vt, vt), b.one())
    b.connect(b.is_equal(vt, b.add(vt, b.one())), b.zero())


def case_reducing_factor(b, pw, rng, pkg):
    alpha = rng.ext()
    vals = [rng.ext() for _ in range(40)]    # past n_ops + 1: the gate
    acc = (0, 0)
    for v in reversed(vals):
        acc = ge.s_add(ge.s_mul(acc, alpha), v)
    vts = b.add_virtual_extension_targets(len(vals))
    pw.set_extension_targets(vts, vals)
    red = pkg.reducing(b.constant_extension(alpha)).reduce(vts, b)
    b.connect_extension(red, b.constant_extension(acc))

    base_vals = [rng.below(gl.P) for _ in range(50)]
    acc2 = (0, 0)
    for v in reversed(base_vals):
        acc2 = ge.s_add(ge.s_mul(acc2, alpha), (v, 0))
    bts = [b.add_virtual_target() for _ in base_vals]
    for t, v in zip(bts, base_vals):
        pw.set_target(t, v)
    rf = pkg.reducing(b.constant_extension(alpha))
    b.connect_extension(rf.reduce_base(bts, b), b.constant_extension(acc2))
    # a short reduction (arithmetic gates), then a shift by alpha^count
    short = (0, 0)
    for v in reversed(vals[:5]):
        short = ge.s_add(ge.s_mul(short, alpha), v)
    shifted = rf.shift(rf.reduce(vts[:5], b), b)
    b.connect_extension(shifted, b.constant_extension(
        ge.s_mul(ge.s_exp(alpha, 55), short)))


def case_polynomial(b, pw, rng, pkg):
    coeffs = [rng.ext() for _ in range(20)]
    ct = b.add_virtual_extension_targets(len(coeffs))
    pw.set_extension_targets(ct, coeffs)
    poly = pkg.polynomial(ct)
    zeta, x = rng.ext(), rng.below(gl.P)
    for point, pt in ((zeta, b.constant_extension(zeta)),
                      ((x, 0), None)):
        want = (0, 0)
        for c in reversed(coeffs):
            want = ge.s_add(ge.s_mul(want, point), c)
        got = (poly.eval(b, pt) if pt is not None
               else poly.eval_scalar(b, b.constant(x)))
        b.connect_extension(got, b.constant_extension(want))


def _interpolation(subgroup_bits, high_degree):
    def case(b, pw, rng, pkg):
        n = 1 << subgroup_bits
        shift = rng.below(gl.P - 1) + 1
        g = gl.primitive_root_of_unity(subgroup_bits)
        x, points, values = shift, [], []
        for _ in range(n):
            y = rng.ext()
            points.append(((x, 0), y))
            values.append(y)
            x = x * g % gl.P
        coeffs = pkg.interpolant(points)
        zeta = rng.ext()
        expect = (0, 0)
        for c in reversed(coeffs):
            expect = ge.s_add(ge.s_mul(expect, zeta), c)
        out = b.interpolate_coset(subgroup_bits, b.constant(shift),
                                  [b.constant_extension(v) for v in values],
                                  b.constant_extension(zeta),
                                  high_degree=high_degree)
        b.connect_extension(out, b.constant_extension(expect))
    return case


CASES = {
    "extension arithmetic, division, exp": case_extension_arithmetic,
    "split, select, random access": case_split_select_random_access,
    "reducing factor": case_reducing_factor,
    "polynomial evaluation": case_polynomial,
    "interpolation 2 low": _interpolation(2, False),
    "interpolation 4 low": _interpolation(4, False),
    "interpolation 2 high": _interpolation(2, True),
}


class _Draws:
    """The case's values, from one seeded stream."""

    def __init__(self, seed):
        self.r = random.Random(seed)

    def below(self, n):
        return self.r.randrange(n)

    def ext(self):
        return (self.r.randrange(gl.P), self.r.randrange(gl.P))


def _build(pkg, case, seed):
    b, pw = pkg.builder(), pkg.pw()
    case(b, pw, _Draws(seed), pkg)
    return (b.build(device="cpu") if pkg is PORT else b.build()), pw


def _assert_constraints_vanish(data, pwit):
    common = data.common
    wires = pwit.full_witness()                         # (num_wires, n)
    coeffs = data.prover_only.constants_sigmas_commitment.polynomials
    consts = to_u64(fft.fft(from_u64(coeffs[:common.num_constants], "cpu")))
    pis = pwit.get_targets(data.prover_only.public_inputs)
    pih = pos.hash_no_pad(np.array(pis, dtype=np.uint64))
    vars = EvaluationVars(list(consts), list(wires),
                          [np.uint64(x) for x in pih])
    for k, c in enumerate(evaluate_gate_constraints(NumpyBatch(), common,
                                                    vars)):
        assert not np.asarray(c).any(), f"constraint {k} does not vanish"


@pytest.mark.parametrize("name", list(CASES))
def test_gadget_witness_equals_jax(monkeypatch, name):
    case, seed = CASES[name], len(name)
    jd, jpw = _build(JAX, case, seed)
    td, tpw = _build(PORT, case, seed)
    assert [g.id() for g in td.common.gates] == \
        [g.id() for g in jd.common.gates]
    assert [type(g).__name__ for g in td.prover_only.generators] == \
        [type(g).__name__ for g in jd.prover_only.generators]
    pin_randomness(monkeypatch, seed)
    want = jax_generate(jpw, jd.prover_only, jd.common).full_witness()
    pwit = generate_partial_witness(tpw, td.prover_only, td.common,
                                    rng=random.Random(seed))
    np.testing.assert_array_equal(pwit.full_witness(), want)
    _assert_constraints_vanish(td, pwit)
