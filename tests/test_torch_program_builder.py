"""The port's quotient compiler against the JAX package's, on the CPU.

- ``ProgramBuilder`` and ``ExprAlgebra`` as tests/test_constraint_program.py
  holds the JAX ones: mul-add fusion, common subexpressions, constant
  folding, ``exp``; the programs run by ``run_plain``;
- ``build_quotient_program`` equals the JAX compiler's output array for
  array (``ConstraintProgram.arrays()``) for fibonacci, factorial, square
  root, a hash chain, the hash tree of 2^3 leaves under both configs and
  the gate mix; the 2^3-leaf tree under wide_ecc_config compiles to the
  shipped flagship program (plonk/programs/hash_tree_wide_ecc.npz);
- each compiled program run by ``run_plain`` equals JAX's ``run_numpy``
  on random inputs.

Exact equality throughout (field elements and integer arrays).
"""
import functools
import os

import numpy as np
import pytest

from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.plonk import constraint_program as jcp
from plonky2_tpu.plonk.quotient_program import \
    build_quotient_program as jax_build_quotient_program
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.plonk import constraint_program as cp
from plonky2_tpu_torch.plonk.constraint_program import (ExprAlgebra,
                                                        ProgramBuilder)
from plonky2_tpu_torch.plonk.quotient_program import build_quotient_program
from tests.test_torch_prover import one_torch_thread  # noqa: F401

P = jgl.P
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(REPO, "plonky2_tpu_torch", "plonk", "programs",
                       "hash_tree_wide_ecc.npz")


@functools.lru_cache(maxsize=None)
def circuit_pair(name: str, size: int = 0):
    """(JAX (data, pw, expected), port (data, pw, expected)) of one
    circuit, the port's built on the CPU; `expected` is the public inputs
    (None where the model gives none)."""
    from plonky2_tpu.plonk.circuit_builder import CircuitBuilder as JB
    from plonky2_tpu.plonk.config import CircuitConfig as JC
    from plonky2_tpu_torch.plonk.config import CircuitConfig as TC
    if name in ("fibonacci", "hash_tree_wide"):
        from tests.test_torch_circuit_builder import circuits
        return circuits("fibonacci" if name == "fibonacci" else "hash_tree",
                        size)
    if name == "hash_tree_std":
        from plonky2_tpu.models.hash_tree import build_hash_tree_circuit as j
        from plonky2_tpu_torch.models.hash_tree import \
            build_hash_tree_circuit as t
        return (j(JC.standard_recursion_config(), size),
                t(TC.standard_recursion_config(), size, device="cpu"))
    if name == "factorial":
        from plonky2_tpu.models.examples import build_factorial_circuit as j
        from plonky2_tpu_torch.models.examples import \
            build_factorial_circuit as t
        return j(terms=size), t(terms=size, device="cpu")
    if name == "square_root":
        from plonky2_tpu.models.examples import build_square_root_circuit as j
        from plonky2_tpu_torch.models.examples import \
            build_square_root_circuit as t
        return (*j(size), None), (*t(size, device="cpu"), None)
    if name == "hash_chain":
        from plonky2_tpu.models.hash_chain import \
            build_hash_chain_circuit as j
        from plonky2_tpu_torch.models.hash_chain import (
            build_hash_chain_circuit as t, expected_chain_output)
        (jd, jw), (td, tw) = j(length=size), t(length=size, device="cpu")
        want = expected_chain_output(12345, size)
        return (jd, jw(12345), want), (td, tw(12345), want)
    if name == "gate_mix":
        from plonky2_tpu.gadgets.reducing import ReducingFactorTarget
        from plonky2_tpu.gates.advanced import PoseidonMdsGate
        from plonky2_tpu.iop.witness import PartialWitness
        from plonky2_tpu_torch.models.gate_mix import (build_gate_mix_circuit,
                                                       place_gate_mix)
        jb = JB(JC.standard_recursion_config())
        jpw = PartialWitness()
        rng = np.random.default_rng(0)
        for _ in range(size):
            jb.register_public_inputs(place_gate_mix(
                jb, jpw, rng, PoseidonMdsGate(), ReducingFactorTarget))
        td, tpw, _ = build_gate_mix_circuit(copies=size, device="cpu")
        return (jb.build(), jpw, None), (td, tpw, None)
    raise ValueError(name)


CIRCUITS = [("fibonacci", 99), ("factorial", 100), ("square_root", 4),
            ("hash_chain", 8), ("hash_tree_wide", 3), ("hash_tree_std", 3),
            ("gate_mix", 1)]


def _equal_arrays(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _run_both(prog, jprog, lanes: int, seed: int):
    """run_plain and JAX's run_numpy on the same random inputs."""
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, P, size=(prog.n_inputs, lanes), dtype=np.uint64)
    scal = [int(v) for v in rng.integers(0, P, size=prog.n_scalar_inputs,
                                         dtype=np.uint64)]
    bank = from_u64(prog.scalar_bank(scal), "cpu")
    got = to_u64(prog.run_plain(from_u64(inputs, "cpu"), bank))
    return got, jprog.run_numpy(inputs, scal)


def test_builder_basics_and_fusion():
    b = ProgramBuilder()
    alg = ExprAlgebra(b)
    x, y = b.vector_input(), b.vector_input()
    s = b.scalar_input()
    # e = (x*y + x) * (s - y) + 7 ; f = x * 3 + s
    e = alg.add_const(alg.mul(alg.add(alg.mul(x, y), x), alg.sub(s, y)), 7)
    f = alg.add(alg.mul_const(x, 3), s)
    b.mark_output(e)
    b.mark_output(f)
    prog = b.compile(wave_width=4)
    assert prog.n_inputs == 2
    counts = prog.real_op_counts()
    assert counts["muladd"] == 1            # x*y + x, fused

    rng = np.random.default_rng(0)
    xv, yv = rng.integers(0, P, size=(2, 8), dtype=np.uint64)
    sv = 123456789
    out = to_u64(prog.run_plain(from_u64(np.stack([xv, yv]), "cpu"),
                                from_u64(prog.scalar_bank([sv]), "cpu")))
    e_ref = jgl.add(jgl.mul(jgl.add(jgl.mul(xv, yv), xv),
                            jgl.sub(np.uint64(sv), yv)), np.uint64(7))
    f_ref = jgl.add(jgl.mul(xv, np.uint64(3)), np.uint64(sv))
    np.testing.assert_array_equal(out[0], e_ref)
    np.testing.assert_array_equal(out[1], f_ref)

    # the same trace through the JAX builder gives the same program
    jb = jcp.ProgramBuilder()
    ja = jcp.ExprAlgebra(jb)
    x, y = jb.vector_input(), jb.vector_input()
    s = jb.scalar_input()
    jb.mark_output(ja.add_const(ja.mul(ja.add(ja.mul(x, y), x),
                                       ja.sub(s, y)), 7))
    jb.mark_output(ja.add(ja.mul_const(x, 3), s))
    _equal_arrays(prog.arrays(),
                  cp.program_from_arrays(jb.compile(wave_width=4)).arrays())


def test_cse_and_constant_folding():
    b = ProgramBuilder()
    alg = ExprAlgebra(b)
    x = b.vector_input()
    a1 = alg.mul(x, x)
    a2 = alg.mul(x, x)              # one node
    assert a1.id == a2.id and a1.kind == "v"
    k = alg.mul_const(alg.const(3), 5)      # folds to 15
    assert b.snodes[k.id] == ("k", 15)
    assert alg.mul_const(x, 0).kind == "s"  # folds to the scalar zero
    one = alg.mul_const(x, 1)               # the identity
    assert one.id == x.id and one.kind == "v"
    assert alg.sub(x, x).kind == "s"        # x - x = 0
    assert alg.add(x, alg.zero()) is x
    s = b.scalar_input()
    assert alg.add(s, x).id == alg.add(x, s).id   # commuted the same way
    with pytest.raises(ValueError, match="scalar outputs"):
        b.mark_output(k)
        b.compile()


def test_exp_square_and_multiply():
    b = ProgramBuilder()
    alg = ExprAlgebra(b)
    x = b.vector_input()
    b.mark_output(alg.exp(x, 7))
    prog = b.compile()
    xv = np.array([3, 5, P - 2, 0, 1], dtype=np.uint64)
    out = to_u64(prog.run_plain(from_u64(xv[None], "cpu"),
                                from_u64(prog.scalar_bank([]), "cpu")))
    expect = np.array([pow(int(v), 7, P) for v in xv], dtype=np.uint64)
    np.testing.assert_array_equal(out[0], expect)
    # x^7 = x * x^2 * x^4: two squares and two products
    assert prog.n_ops == 4


@pytest.mark.parametrize("name,size", CIRCUITS)
def test_quotient_program_equals_jax(name, size):
    """The port's compile of the circuit equals JAX's, array for array,
    and runs to the same values as JAX's run_numpy."""
    (jd, _, _), (td, _, _) = circuit_pair(name, size)
    assert [g.id() for g in td.common.gates] == \
        [g.id() for g in jd.common.gates]
    prog = build_quotient_program(td.common)
    jprog = jax_build_quotient_program(jd.common)
    _equal_arrays(prog.arrays(), cp.program_from_arrays(jprog).arrays())
    got, want = _run_both(prog, jprog, 16, seed=len(name))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["hash_tree_wide", "hash_tree_std"])
def test_compiles_are_deterministic(name):
    """Two compiles of one circuit (hash-consing in dicts, ties in the
    schedule and the allocator) give the same arrays."""
    (_, _, _), (td, _, _) = circuit_pair(name, 3)
    _equal_arrays(build_quotient_program(td.common).arrays(),
                  build_quotient_program(td.common).arrays())


def test_tree_compiles_to_the_shipped_program():
    (_, _, _), (td, _, _) = circuit_pair("hash_tree_wide", 3)
    shipped, shape = cp.load(SHIPPED)
    _equal_arrays(build_quotient_program(td.common).arrays(),
                  shipped.arrays())
    assert cp.load_gate_ids(SHIPPED) == tuple(g.id()
                                              for g in td.common.gates)


def test_standard_config_tree_program_shape():
    """Under standard_recursion_config the tree's program reads 135 wire
    columns (the gather and K6 see this shape on the card)."""
    from plonky2_tpu_torch.plonk.circuit_shape import CircuitShape
    (_, _, _), (td, _, _) = circuit_pair("hash_tree_std", 3)
    prog = build_quotient_program(td.common)
    shape = CircuitShape.from_common(td.common)
    assert shape.num_wires == 135
    assert prog.n_inputs == (shape.num_preprocessed_polys + shape.num_wires
                             + shape.num_zs_pp + shape.num_challenges + 3)
    assert prog.n_outputs == 2
