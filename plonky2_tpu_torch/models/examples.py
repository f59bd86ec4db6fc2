"""Example circuits: factorial and square root (the port's copy of
plonky2_tpu/models/examples.py; reference
plonky2/examples/{factorial,square_root}.rs)."""
from __future__ import annotations

from ..field import goldilocks as gl
from ..iop.generator import SimpleGenerator
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig


def build_factorial_circuit(config: CircuitConfig | None = None,
                            terms: int = 100, device=None):
    """'I know n * (n+1) * ... * (n+terms-1)' (reference
    factorial.rs:11-43).  (data, pw, expected public inputs); ``device``
    goes to CircuitBuilder.build."""
    config = config or CircuitConfig.standard_recursion_config()
    builder = CircuitBuilder(config)
    initial = builder.add_virtual_target()
    cur = initial
    for i in range(2, terms + 1):
        cur = builder.mul(cur, builder.constant(i))
    builder.register_public_input(initial)
    builder.register_public_input(cur)

    pw = PartialWitness()
    pw.set_target(initial, 1)
    data = builder.build(device=device)

    expected = 1
    for i in range(2, terms + 1):
        expected = expected * i % gl.P
    return data, pw, [1, expected]


def sqrt_mod_p(a: int) -> int:
    """A square root in Goldilocks by Tonelli-Shanks (p - 1 = 2^32 m)."""
    if a == 0:
        return 0
    if pow(a, (gl.P - 1) // 2, gl.P) != 1:
        raise ValueError(f"{a} is not a quadratic residue")
    m = (gl.P - 1) >> 32
    z = pow(gl.MULTIPLICATIVE_GROUP_GENERATOR, m, gl.P)  # a 2^32-th root
    x = pow(a, (m + 1) // 2, gl.P)
    t = pow(a, m, gl.P)
    s = 32
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % gl.P
            i += 1
        b = pow(z, 1 << (s - i - 1), gl.P)
        x = x * b % gl.P
        t = t * b % gl.P * b % gl.P
        z = b * b % gl.P
        s = i
    return x


class SquareRootGenerator(SimpleGenerator):
    """(reference square_root.rs:18-39)."""

    def __init__(self, x, x_squared):
        self.x = x
        self.x_squared = x_squared

    def dependencies(self):
        return [self.x_squared]

    def run_once(self, witness, out):
        out.append((self.x, sqrt_mod_p(witness.get_target(self.x_squared))))


def build_square_root_circuit(x_squared_value: int = 4,
                              config: CircuitConfig | None = None,
                              device=None):
    """'I know the square root of this field element' (reference
    square_root.rs:42-85).  (data, pw)."""
    config = config or CircuitConfig.standard_recursion_config()
    builder = CircuitBuilder(config)
    x = builder.add_virtual_target()
    x_squared = builder.mul(x, x)
    builder.register_public_input(x_squared)
    builder.generators.append(SquareRootGenerator(x, x_squared))

    pw = PartialWitness()
    pw.set_target(x_squared, x_squared_value)
    data = builder.build(device=device)
    return data, pw
