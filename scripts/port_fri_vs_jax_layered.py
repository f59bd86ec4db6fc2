"""The port's FRI opening proof against the JAX package's layered device
path, byte for byte, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/port_fri_vs_jax_layered.py [16|256]

The JAX package's ``device_prove_openings`` is run with its layered FRI
(``_device_fri_proof_layered``, the path of every config whose hasher is
not algebraic) and with ``jax.disable_jit()``: its jitted fold programs
take many minutes to compile for the CPU, eagerly the whole proof takes a
few minutes.  Inputs are tests/test_torch_fri.py's (random oracles of 5, 7
and 3 polynomials of degree 2^10, two opening batches), at the flagship
arity 16 or at the arity 256 of __graft_entry__.py:_fast_config.  Prints
the seconds the JAX path took and whether the serialized proofs and the
transcripts after them are equal; exits 1 if not.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

import plonky2_tpu.fri.device_prover as jdp  # noqa: E402
import tests.test_torch_fri as tf  # noqa: E402
from plonky2_tpu.utils.serialization import Buffer  # noqa: E402
from plonky2_tpu_torch.fri import device_prover as tdp  # noqa: E402
from plonky2_tpu_torch.plonk.prover_data import fri_params_from  # noqa: E402


def main() -> int:
    arity = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    config = {16: tf.FLAGSHIP_ARITY, 256: tf.GRAFT_ARITY}[arity]
    logn = 10
    jo, to, jinst, tinst, jopen, topen = tf.case(logn, config.cap_height)
    params = config.fri_params(logn, False)
    ours, ref = tf.challengers()
    t = time.perf_counter()
    fused = jdp.device_fri_proof
    jdp.device_fri_proof = jdp._device_fri_proof_layered
    try:
        with jax.disable_jit():
            want = jdp.device_prove_openings(jinst, jo, jopen, ref, params)
    finally:
        jdp.device_fri_proof = fused
    jax_s = time.perf_counter() - t
    got = tdp.device_prove_openings(tinst, to, topen, ours,
                                    fri_params_from(params))
    a, b = Buffer(), Buffer()
    a.write_fri_proof(tf.to_jax_fri_proof(got))
    b.write_fri_proof(want)
    same = a.bytes() == b.bytes() and ours.sponge_state == [
        int(x) for x in ref.sponge_state]
    print(f"arity {arity}: JAX layered device path {jax_s:.1f} s (eager); "
          f"proofs and transcripts equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
