"""ProverSession on the JAX package's example circuits, on the CPU.

Factorial (100 terms), square root and a Poseidon hash chain of 8 links
(models/examples.py, models/hash_chain.py), under
standard_recursion_config: the session compiles each circuit's quotient
program, and its proof serializes byte for byte like the JAX prover's
under the same seeded witness randomness; both verifiers accept it.
"""
import pytest

from tests.test_torch_prover import one_torch_thread  # noqa: F401
from tests.test_torch_session import assert_session_proof_equals_jax


@pytest.mark.parametrize("name,size", [("factorial", 100),
                                       ("square_root", 4),
                                       ("hash_chain", 8)])
def test_example_proof_equals_jax(monkeypatch, name, size):
    assert_session_proof_equals_jax(monkeypatch, name, size)
