"""Coset-interpolation gates, their generators and the gadget that places
them (the port's copy of plonky2_tpu/gates/interpolation.py; reference
gates/interpolation.rs, low_degree_interpolation.rs,
high_degree_interpolation.rs).

A gate interpolates the polynomial whose points are a coset (shift times
the two-adic subgroup of size 2^subgroup_bits, in the base field) and whose
values are extension elements, and evaluates it at an extension point: the
recursive FRI verifier's check of one fold.  ``LowDegreeInterpolationGate``
keeps every constraint at degree 2 with helper wires that hold the powers
of the shift and of the point; ``HighDegreeInterpolationGate`` has no
helper wires and degree 2^subgroup_bits.
"""
from __future__ import annotations

from typing import List, Tuple

from ..field import extension as ge
from ..field import goldilocks as gl
from ..iop.generator import SimpleGenerator
from .ext_algebra import (ea_add, ea_mul, ea_scalar_mul, ea_scalar_mul_const,
                          ea_sub, get_local_ext)
from .gate import Gate

D = 2


def interpolant(points: List[Tuple[Tuple[int, int], Tuple[int, int]]]):
    """The coefficients (extension pairs, lowest first) of the polynomial
    through the (x, y) extension points, by Lagrange interpolation
    (reference field/src/interpolation.rs)."""
    n = len(points)
    coeffs = [(0, 0)] * n
    for i, (xi, yi) in enumerate(points):
        # basis_i(X) = prod_{j != i} (X - x_j) / (x_i - x_j)
        basis = [(1, 0)] + [(0, 0)] * (n - 1)
        deg = 0
        denom = (1, 0)
        for j, (xj, _) in enumerate(points):
            if j == i:
                continue
            # basis *= (X - xj)
            new = [(0, 0)] * (deg + 2)
            for k in range(deg + 1):
                new[k + 1] = ge.s_add(new[k + 1], basis[k])
                new[k] = ge.s_sub(new[k], ge.s_mul(basis[k], xj))
            basis = new + [(0, 0)] * (n - len(new))
            deg += 1
            denom = ge.s_mul(denom, ge.s_sub(xi, xj))
        scale = ge.s_mul(yi, ge.s_inv(denom))
        for k in range(n):
            coeffs[k] = ge.s_add(coeffs[k], ge.s_mul(basis[k], scale))
    return coeffs


class LowDegreeInterpolationGate(Gate):
    def __init__(self, subgroup_bits: int):
        self.subgroup_bits = subgroup_bits

    def id(self):
        return (f"LowDegreeInterpolationGate {{ subgroup_bits: "
                f"{self.subgroup_bits}, _phantom: PhantomData"
                f"<plonky2_field::goldilocks_field::GoldilocksField> }}<D=2>")

    def num_points(self) -> int:
        return 1 << self.subgroup_bits

    # -- wire layout (reference interpolation.rs:22-77) --------------------

    def wire_shift(self) -> int:
        return 0

    def start_values(self) -> int:
        return 1

    def wires_value(self, i: int) -> range:
        start = self.start_values() + i * D
        return range(start, start + D)

    def start_evaluation_point(self) -> int:
        return self.start_values() + self.num_points() * D

    def wires_evaluation_point(self) -> range:
        start = self.start_evaluation_point()
        return range(start, start + D)

    def start_evaluation_value(self) -> int:
        return self.start_evaluation_point() + D

    def wires_evaluation_value(self) -> range:
        start = self.start_evaluation_value()
        return range(start, start + D)

    def start_coeffs(self) -> int:
        return self.start_evaluation_value() + D

    def num_routed_wires(self) -> int:
        return self.start_coeffs()

    def wires_coeff(self, i: int) -> range:
        start = self.start_coeffs() + i * D
        return range(start, start + D)

    def end_coeffs(self) -> int:
        return self.start_coeffs() + D * self.num_points()

    # helper wires specific to the low-degree variant
    # (reference low_degree_interpolation.rs:51-73)

    def powers_shift(self, i: int) -> int:
        if not 0 < i < self.num_points():
            raise ValueError(f"no power {i} of the shift")
        if i == 1:
            return self.wire_shift()
        return self.end_coeffs() + i - 2

    def powers_evaluation_point(self, i: int) -> range:
        if not 0 < i < self.num_points():
            raise ValueError(f"no power {i} of the evaluation point")
        if i == 1:
            return self.wires_evaluation_point()
        start = (self.end_coeffs() + self.num_points() - 2 + (i - 2) * D)
        return range(start, start + D)

    def end(self) -> int:
        if self.num_points() == 2:  # no helper power wires needed
            return self.end_coeffs()
        return self.powers_evaluation_point(self.num_points() - 1).stop

    # -- constraints --------------------------------------------------------

    def eval_unfiltered(self, alg, vars):
        n = self.num_points()
        constraints = []

        coeffs = [get_local_ext(vars, self.wires_coeff(i)) for i in range(n)]
        powers_shift = [vars.local_wires[self.powers_shift(i)]
                        for i in range(1, n)]
        shift = powers_shift[0]
        for i in range(1, n - 1):
            constraints.append(
                alg.sub(alg.mul(powers_shift[i - 1], shift), powers_shift[i]))
        powers_shift.insert(0, alg.one())

        # altered[i] = c_i shift^i, so altered(w^j) = original(shift w^j)
        altered = [ea_scalar_mul(alg, c, p)
                   for c, p in zip(coeffs, powers_shift)]

        g = gl.primitive_root_of_unity(self.subgroup_bits)
        point = 1
        for i in range(n):
            value = get_local_ext(vars, self.wires_value(i))
            computed = (alg.zero(), alg.zero())
            for c in reversed(altered):
                computed = ea_add(
                    alg, ea_scalar_mul_const(alg, computed, point), c)
            constraints.extend(ea_sub(alg, value, computed))
            point = point * g % gl.P

        eval_powers = [get_local_ext(vars, self.powers_evaluation_point(i))
                       for i in range(1, n)]
        eval_point = eval_powers[0]
        for i in range(1, n - 1):
            constraints.extend(
                ea_sub(alg, ea_mul(alg, eval_powers[i - 1], eval_point),
                       eval_powers[i]))
        evaluation_value = get_local_ext(vars, self.wires_evaluation_value())
        computed = coeffs[0]
        for c, p in zip(coeffs[1:], eval_powers):
            computed = ea_add(alg, computed, ea_mul(alg, c, p))
        constraints.extend(ea_sub(alg, evaluation_value, computed))
        return constraints

    def generators(self, row, local_constants):
        return [InterpolationGenerator(row, self)]

    def num_wires(self):
        return self.end()

    def num_constants(self):
        return 0

    def degree(self):
        return 2

    def num_constraints(self):
        n = self.num_points()
        return n * D + D + (D + 1) * (n - 2)


class InterpolationGenerator(SimpleGenerator):
    def __init__(self, row, gate: LowDegreeInterpolationGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        g = self.gate
        cols = [g.wire_shift()]
        cols += list(g.wires_evaluation_point())
        for i in range(g.num_points()):
            cols += list(g.wires_value(i))
        return [("w", self.row, c) for c in cols]

    def run_once(self, witness, out):
        g = self.gate
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        wext = lambda r: (w(r.start), w(r.start + 1))  # noqa: E731

        shift = w(g.wire_shift())
        power = shift * shift % gl.P
        for i in range(2, g.num_points()):
            out.append((("w", self.row, g.powers_shift(i)), power))
            power = power * shift % gl.P

        root = gl.primitive_root_of_unity(g.subgroup_bits)
        points = []
        x = shift
        for i in range(g.num_points()):
            points.append(((x, 0), wext(g.wires_value(i))))
            x = x * root % gl.P
        coeffs = interpolant(points)
        for i, c in enumerate(coeffs):
            r = g.wires_coeff(i)
            out.append((("w", self.row, r.start), c[0]))
            out.append((("w", self.row, r.start + 1), c[1]))

        zeta = wext(g.wires_evaluation_point())
        zp = ge.s_mul(zeta, zeta)
        for i in range(2, g.num_points()):
            r = g.powers_evaluation_point(i)
            out.append((("w", self.row, r.start), zp[0]))
            out.append((("w", self.row, r.start + 1), zp[1]))
            zp = ge.s_mul(zp, zeta)

        acc = (0, 0)
        for c in reversed(coeffs):
            acc = ge.s_add(ge.s_mul(acc, zeta), c)
        r = g.wires_evaluation_value()
        out.append((("w", self.row, r.start), acc[0]))
        out.append((("w", self.row, r.start + 1), acc[1]))


class HighDegreeInterpolationGate(LowDegreeInterpolationGate):
    """The variant without helper wires (reference
    gates/high_degree_interpolation.rs): fewer wires and constraints, degree
    num_points; for a FRI arity that fits the quotient degree factor."""

    def id(self):
        return (f"HighDegreeInterpolationGate {{ subgroup_bits: "
                f"{self.subgroup_bits}, _phantom: PhantomData"
                f"<plonky2_field::goldilocks_field::GoldilocksField> }}<D=2>")

    def end(self) -> int:
        return self.end_coeffs()

    def eval_unfiltered(self, alg, vars):
        n = self.num_points()
        constraints = []
        coeffs = [get_local_ext(vars, self.wires_coeff(i)) for i in range(n)]

        shift = vars.local_wires[self.wire_shift()]
        g = gl.primitive_root_of_unity(self.subgroup_bits)
        gp = 1
        for i in range(n):
            point = alg.mul_const(shift, gp)  # shift * g^i, degree 1
            value = get_local_ext(vars, self.wires_value(i))
            computed = (alg.zero(), alg.zero())
            for c in reversed(coeffs):
                computed = ea_add(alg, ea_scalar_mul(alg, computed, point), c)
            constraints.extend(ea_sub(alg, value, computed))
            gp = gp * g % gl.P

        eval_point = get_local_ext(vars, self.wires_evaluation_point())
        eval_value = get_local_ext(vars, self.wires_evaluation_value())
        computed = (alg.zero(), alg.zero())
        for c in reversed(coeffs):
            computed = ea_add(alg, ea_mul(alg, computed, eval_point), c)
        constraints.extend(ea_sub(alg, eval_value, computed))
        return constraints

    def generators(self, row, local_constants):
        return [HighDegreeInterpolationGenerator(row, self)]

    def degree(self):
        return self.num_points()

    def num_constraints(self):
        return self.num_points() * D + D


class HighDegreeInterpolationGenerator(InterpolationGenerator):
    def run_once(self, witness, out):
        g = self.gate
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        wext = lambda r: (w(r.start), w(r.start + 1))  # noqa: E731

        shift = w(g.wire_shift())
        root = gl.primitive_root_of_unity(g.subgroup_bits)
        points = []
        x = shift
        for i in range(g.num_points()):
            points.append(((x, 0), wext(g.wires_value(i))))
            x = x * root % gl.P
        coeffs = interpolant(points)
        for i, c in enumerate(coeffs):
            r = g.wires_coeff(i)
            out.append((("w", self.row, r.start), c[0]))
            out.append((("w", self.row, r.start + 1), c[1]))

        zeta = wext(g.wires_evaluation_point())
        acc = (0, 0)
        for c in reversed(coeffs):
            acc = ge.s_add(ge.s_mul(acc, zeta), c)
        r = g.wires_evaluation_value()
        out.append((("w", self.row, r.start), acc[0]))
        out.append((("w", self.row, r.start + 1), acc[1]))


class InterpolationGadgets:
    """Mixed into CircuitBuilder (reference interpolation.rs:79-103)."""

    def interpolate_coset(self, subgroup_bits: int, coset_shift,
                          values: list, evaluation_point,
                          high_degree: bool = False) -> tuple:
        from ..gadgets.extension import ext_from_range
        gate = (HighDegreeInterpolationGate(subgroup_bits) if high_degree
                else LowDegreeInterpolationGate(subgroup_bits))
        row = self.add_gate(gate, [])
        self.connect(coset_shift, ("w", row, gate.wire_shift()))
        for i, v in enumerate(values):
            self.connect_extension(v, ext_from_range(row,
                                                     gate.wires_value(i)))
        self.connect_extension(evaluation_point, ext_from_range(
            row, gate.wires_evaluation_point()))
        return ext_from_range(row, gate.wires_evaluation_value())
