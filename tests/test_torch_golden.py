"""tests/test_golden.py's golden vectors against the port, on the CPU.

- The field's multiplication and inverse vectors against the port's numpy
  field (field/goldilocks.py) and its torch field (field/gf.py).
- The FFT known answers (Horner at the subgroup and coset points) against
  the port's NTT oracle (field/fft.py).
- The frozen Fibonacci transcript: the port's CPU proof of the seeded
  Fibonacci circuit under tests/test_plonk.py:fast_test_config has the
  frozen circuit digest, length and sha256.  The constants are read from
  tests/test_golden.py.
"""
import hashlib
import random

import numpy as np
import pytest
import torch

import tests.test_golden as golden
from plonky2_tpu_torch.field import fft, gf
from plonky2_tpu_torch.field import goldilocks as gl
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.models.fibonacci import build_fibonacci_circuit
from plonky2_tpu_torch.runtime.session import ProverSession
from plonky2_tpu_torch.utils.serialization import serialize_proof
from tests.test_torch_circuit_builder import port_fast_test_config

P = golden.P


def _cpu(values) -> torch.Tensor:
    return from_u64(np.array(values, dtype=np.uint64), "cpu")


@pytest.mark.parametrize("a,b,c", golden.FIELD_MUL_VECTORS)
def test_field_mul_golden(a, b, c):
    assert a * b % P == c
    assert int(gl.mul(np.uint64(a), np.uint64(b))) == c
    assert int(to_u64(gf.mul(_cpu([a]), _cpu([b])))[0]) == c


def test_field_inverse_golden():
    values = [1, 2, 0xFFFFFFFF, 1 << 32, P - 1, 0xFFFFFFFF00000000]
    want = [pow(a, P - 2, P) for a in values]
    assert [int(x) for x in gl.inverse(np.array(values, np.uint64))] == want
    assert [int(x) for x in to_u64(gf.inverse(_cpu(values)))] == want
    assert all(a * w % P == 1 for a, w in zip(values, want))


def _horner(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def test_fft_known_answer():
    coeffs = [3, 1, 4, 1, 5, 9, 2, 6]
    w = gl.primitive_root_of_unity(3)
    expect = [_horner(coeffs, pow(w, i, P)) for i in range(8)]
    got = fft.fft(_cpu([coeffs]))
    assert [int(x) for x in to_u64(got)[0]] == expect
    assert [int(x) for x in to_u64(fft.ifft(got))[0]] == coeffs


def test_coset_fft_known_answer():
    g = gl.coset_shift()
    w = gl.primitive_root_of_unity(2)
    expect = [(7 + 2 * pow(g * pow(w, i, P) % P, 3, P)) % P for i in range(4)]
    got = fft.coset_fft(_cpu([[7, 0, 0, 2]]), g)
    assert [int(x) for x in to_u64(got)[0]] == expect


def test_frozen_fibonacci_transcript():
    data, pw, _ = build_fibonacci_circuit(port_fast_test_config(),
                                          device="cpu")
    assert [int(x) for x in data.prover_only.circuit_digest] == \
        golden.FROZEN_CIRCUIT_DIGEST
    proof = ProverSession(data, device="cpu").prove(
        pw, rng=random.Random(0x60))
    raw = serialize_proof(proof)
    assert len(raw) == golden.FROZEN_PROOF_LEN
    assert hashlib.sha256(raw).hexdigest() == golden.FROZEN_PROOF_SHA256
