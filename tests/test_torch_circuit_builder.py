"""The port's circuit builder against the JAX package's, on the CPU.

For the hash tree of 2^2-2^5 leaves under CircuitConfig.wide_ecc_config()
(the flagship's family) and for the fibonacci circuit under the fast test
config, plonky2_tpu_torch's ``build(device="cpu")`` gives JAX's
``build()``: the gates in order, the selectors, the constants-sigmas
coefficients and the sigma values (exact uint64), k_is, the
representative map, the public inputs, the constants-sigmas cap, the
circuit digest, the FRI parameters, the generators per class and the
generators' watch index.  The session compiles the trees' quotient
program, which is the shipped one, and compiles and proves fibonacci.
The port's build of the tree of 2^10 leaves under
standard_recursion_config equals the JAX build committed in
plonky2_tpu_torch/plonk/programs/hash_tree_standard_k10.json."""
import collections
import functools
import json
import os

import numpy as np
import pytest

from plonky2_tpu.models.fibonacci import \
    build_fibonacci_circuit as jax_fibonacci
from plonky2_tpu.models.hash_tree import \
    build_hash_tree_circuit as jax_hash_tree
from plonky2_tpu.plonk.config import CircuitConfig as JaxCircuitConfig
from plonky2_tpu_torch.fri.config import FriConfig, FriReductionStrategy
from plonky2_tpu_torch.models.fibonacci import build_fibonacci_circuit
from plonky2_tpu_torch.models.hash_tree import build_hash_tree_circuit
from plonky2_tpu_torch.plonk.config import CircuitConfig
from plonky2_tpu_torch.runtime.session import ProverSession
from tests.test_plonk import fast_test_config
from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_quotient import STANDARD_JSON

SHIPPED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "plonky2_tpu_torch", "plonk", "programs",
    "hash_tree_wide_ecc.npz")
CIRCUITS = [("hash_tree", 2), ("hash_tree", 3), ("hash_tree", 4),
            ("hash_tree", 5), ("fibonacci", 99)]


def port_fast_test_config() -> CircuitConfig:
    """tests/test_plonk.py:fast_test_config on the port's classes."""
    fri = FriConfig(rate_bits=3, cap_height=2, proof_of_work_bits=8,
                    reduction_strategy=FriReductionStrategy.ConstantArityBits(
                        4, 5),
                    num_query_rounds=8)
    return CircuitConfig(fri_config=fri, security_bits=1)


@functools.lru_cache(maxsize=None)
def circuits(name: str, size: int):
    """(JAX (data, pw, expected), port (data, pw, expected)), the port's
    built on the CPU."""
    if name == "fibonacci":
        return (jax_fibonacci(fast_test_config(), steps=size),
                build_fibonacci_circuit(port_fast_test_config(), steps=size,
                                        device="cpu"))
    return (jax_hash_tree(JaxCircuitConfig.wide_ecc_config(), size),
            build_hash_tree_circuit(CircuitConfig.wide_ecc_config(), size,
                                    device="cpu"))


def _u64(a):
    return np.asarray(a, dtype=np.uint64)


@pytest.mark.parametrize("name,size", CIRCUITS)
def test_common_data_equals_jax(name, size):
    (jd, _, jexp), (td, _, texp) = circuits(name, size)
    jc, tc = jd.common, td.common
    assert texp == jexp
    assert [g.id() for g in tc.gates] == [g.id() for g in jc.gates]
    assert tc.selectors_info.selector_indices == \
        jc.selectors_info.selector_indices
    assert tc.selectors_info.groups == jc.selectors_info.groups
    for f in ("quotient_degree_factor", "num_gate_constraints",
              "num_constants", "num_public_inputs", "num_partial_products",
              "hasher_name"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.k_is == jc.k_is
    assert tc.degree_bits() == jc.degree_bits()
    tp, jp = tc.fri_params, jc.fri_params
    assert (tp.hiding, tp.degree_bits, tp.reduction_arity_bits) == \
        (jp.hiding, jp.degree_bits, jp.reduction_arity_bits)
    for f in ("rate_bits", "cap_height", "proof_of_work_bits",
              "num_query_rounds"):
        assert getattr(tp.config, f) == getattr(jp.config, f), f
    assert (tp.lde_size(), tp.final_poly_len(), tp.total_arities()) == \
        (jp.lde_size(), jp.final_poly_len(), jp.total_arities())


@pytest.mark.parametrize("name,size", CIRCUITS)
def test_prover_data_equals_jax(name, size):
    (jd, _, _), (td, _, _) = circuits(name, size)
    jpo, tpo = jd.prover_only, td.prover_only
    np.testing.assert_array_equal(
        _u64(tpo.constants_sigmas_commitment.polynomials),
        _u64(jpo.constants_sigmas_commitment.polynomials))
    np.testing.assert_array_equal(_u64(tpo.sigmas), _u64(jpo.sigmas))
    np.testing.assert_array_equal(_u64(tpo.subgroup), _u64(jpo.subgroup))
    np.testing.assert_array_equal(np.asarray(tpo.representative_map),
                                  np.asarray(jpo.representative_map))
    assert tpo.public_inputs == jpo.public_inputs
    np.testing.assert_array_equal(
        _u64(td.verifier_only.constants_sigmas_cap.digests),
        _u64(jd.verifier_only.constants_sigmas_cap.digests))
    np.testing.assert_array_equal(_u64(tpo.circuit_digest),
                                  _u64(jpo.circuit_digest))
    np.testing.assert_array_equal(_u64(td.verifier_only.circuit_digest),
                                  _u64(jpo.circuit_digest))


@pytest.mark.parametrize("name,size", CIRCUITS)
def test_generators_equal_jax(name, size):
    """The same generators, class by class and in order, with the same
    targets, and the same watch index."""
    (jd, _, _), (td, _, _) = circuits(name, size)
    jg, tg = jd.prover_only.generators, td.prover_only.generators
    count = lambda gens: collections.Counter(  # noqa: E731
        type(g).__name__ for g in gens)
    assert count(tg) == count(jg)
    assert [type(g).__name__ for g in tg] == [type(g).__name__ for g in jg]
    for a, b in zip(tg, jg):
        assert a.watch_list() == b.watch_list()
        if getattr(type(a), "batch_group", None):
            assert a.output_targets() == b.output_targets()
    assert td.prover_only.generator_indices_by_watches == \
        jd.prover_only.generator_indices_by_watches


@pytest.mark.parametrize("size", [2, 3, 4, 5])
def test_session_compiles_the_shipped_program_for_trees(size):
    """With no program given, the session compiles the tree's quotient
    program, and it is the shipped flagship program, array for array."""
    from plonky2_tpu_torch.plonk import constraint_program as cp
    (_, _, _), (td, _, _) = circuits("hash_tree", size)
    sess = ProverSession(td, device="cpu")
    prog = sess.prover_data.program
    assert prog.n_inputs == 343 and prog.n_outputs == 2
    shipped, _ = cp.load(SHIPPED)
    for k, v in shipped.arrays().items():
        np.testing.assert_array_equal(np.asarray(prog.arrays()[k]),
                                      np.asarray(v), err_msg=k)
    # one program object a session: the kernel's caches key on it
    assert sess.context.quotient.program is prog


def test_session_compiles_and_proves_fibonacci():
    """A circuit that no shipped program fits (fibonacci) compiles in the
    session and proves, and the proof verifies."""
    import random
    (_, _, _), (td, tpw, texp) = circuits("fibonacci", 99)
    sess = ProverSession(td, device="cpu")
    proof = sess.prove(tpw, rng=random.Random(1))
    assert proof.public_inputs == texp
    sess.verify(proof)


def test_build_defaults_to_cuda(monkeypatch):
    """build() commits on cuda unless told otherwise: without a card it
    raises rather than running the plain versions."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        build_hash_tree_circuit(CircuitConfig.wide_ecc_config(), 2)


def test_standard_reference_file_matches_port_build():
    """The committed JAX build of the hash tree under
    standard_recursion_config at 2^10 leaves
    (tests/test_torch_quotient.py:write_standard_reference; chip_smoke.py
    phase 9c holds the port's build on the card against it) equals the
    port's build on the CPU: degree bits, circuit digest, the 16 cap
    digests and the root."""
    with open(STANDARD_JSON) as f:
        stored = json.load(f)
    assert (stored["log2_leaves"], stored["degree_bits"],
            len(stored["constants_sigmas_cap"])) == (10, 11, 16)
    data, _, root = build_hash_tree_circuit(
        CircuitConfig.standard_recursion_config(), stored["log2_leaves"],
        device="cpu")
    ints = lambda a: [int(x) for x in np.asarray(  # noqa: E731
        a, dtype=np.uint64).reshape(-1)]
    assert data.common.degree_bits() == stored["degree_bits"]
    assert ints(data.prover_only.circuit_digest) == stored["circuit_digest"]
    assert [ints(d) for d in data.verifier_only.constants_sigmas_cap
            .digests] == stored["constants_sigmas_cap"]
    assert root == stored["root"]
