"""The port's constraint programs and quotient against the JAX package.

- The committed flagship program (plonky2_tpu_torch/plonk/programs/
  hash_tree_wide_ecc.npz) equals what the JAX compiler emits for the
  flagship circuit; ``write_flagship_program`` regenerates it.
- ``write_standard_reference`` writes the JAX build of the hash tree
  under standard_recursion_config at 2^10 leaves
  (hash_tree_standard_k10.json), which tests/test_torch_circuit_builder.py
  holds the port's build against.
- ``scalar_bank`` and ``run_plain`` (the plain version of kernel K6) equal
  the JAX package's scalar bank, ``run_numpy``, ``jax_chunk_runner`` and the
  Pallas kernel in interpret mode, on the fibonacci circuit's quotient
  program and on random programs that reuse registers inside a wave.
- The port's DeviceQuotient, fed the port's commitments of the fibonacci
  witness, gives the JAX host prover's quotient coefficients.

Exact equality throughout."""
import functools
import hashlib
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plonky2_tpu.field import gf_jax as gfj
from plonky2_tpu.field import goldilocks as jgl
from plonky2_tpu.plonk.constraint_program import ExprAlgebra, ProgramBuilder
from plonky2_tpu.plonk.quotient_program import (build_quotient_program,
                                                host_quotient_inputs)
from plonky2_tpu.plonk.quotient_program import \
    quotient_scalar_inputs as jax_scalar_inputs
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.ops import partial_products as tpp
from plonky2_tpu_torch.plonk import constraint_program as cp
from plonky2_tpu_torch.plonk.circuit_shape import CircuitShape
from plonky2_tpu_torch.plonk.constraint_program_cuda import run_program_cuda
from plonky2_tpu_torch.plonk.quotient_program import (DeviceQuotient,
                                                      quotient_scalar_inputs)
from tests.test_torch_partial_products import fib_round

P = jgl.P
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_PKL = os.path.join(REPO, ".bench_cache", "hash_tree_k17.pkl")
FLAGSHIP_SHA256 = ("ec7e94f7288e5c0b2b2a021ae34aabfd7dfced0f1e1c38782e5e0"
                   "57fe3381f58")     # the pin bench.py holds
FLAGSHIP_NPZ = os.path.join(REPO, "plonky2_tpu_torch", "plonk", "programs",
                            "hash_tree_wide_ecc.npz")
FLAGSHIP_JSON = os.path.join(REPO, "plonky2_tpu_torch", "plonk", "programs",
                             "hash_tree_wide_ecc_k17.json")
STANDARD_JSON = os.path.join(REPO, "plonky2_tpu_torch", "plonk", "programs",
                             "hash_tree_standard_k10.json")
STANDARD_REF_LOG2_LEAVES = 10
BOUNDARY = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - 1], dtype=np.uint64)


@functools.lru_cache(maxsize=1)
def flagship_pickle():
    """(CommonCircuitData, reference values) of the flagship circuit, from
    the tracked pickle after its sha256 pin is checked (the pickle may run
    code).  The reference values are what FLAGSHIP_JSON holds: degree_bits,
    the circuit digest, the constants-sigmas cap and the expected root."""
    h = hashlib.sha256()
    with open(FLAGSHIP_PKL, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    assert h.hexdigest() == FLAGSHIP_SHA256, "flagship pickle digest changed"
    with open(FLAGSHIP_PKL, "rb") as f:
        payload = pickle.load(f)
    common = payload["common"]
    ints = lambda a: [int(x) for x in np.asarray(  # noqa: E731
        a, dtype=np.uint64).reshape(-1)]
    refs = {"degree_bits": int(common.degree_bits()),
            "circuit_digest": ints(payload["prover_only"]["circuit_digest"]),
            "constants_sigmas_cap": [ints(d) for d in payload[
                "verifier_only"].constants_sigmas_cap.digests],
            "root": ints(payload["extra"][1])}
    return common, refs


def flagship_common():
    """The flagship circuit's CommonCircuitData (``flagship_pickle``)."""
    return flagship_pickle()[0]


def write_flagship_program(path: str = FLAGSHIP_NPZ):
    """Regenerate the committed program file, with the circuit's shape and
    gate ids, from the JAX compiler (needs JAX and the tracked pickle):

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_quotient import \\
            write_flagship_program as w; w()"
    """
    common = flagship_common()
    prog = build_quotient_program(common)
    port = cp.program_from_arrays(prog)
    cp.save(path, port, CircuitShape.from_common(common),
            gate_ids=[g.id() for g in common.gates])
    return prog, port


def write_flagship_reference(path: str = FLAGSHIP_JSON):
    """Regenerate the committed reference values of the flagship circuit
    (``flagship_pickle``), which chip_smoke.py holds the port's build of
    the flagship against:

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_quotient import \\
            write_flagship_reference as w; w()"
    """
    refs = flagship_pickle()[1]
    with open(path, "w") as f:
        json.dump(refs, f, indent=1)
        f.write("\n")
    return refs


def write_standard_reference(path: str = STANDARD_JSON):
    """Regenerate the committed reference values of the hash tree of
    2^STANDARD_REF_LOG2_LEAVES leaves (numpy seed 0) under
    standard_recursion_config, built by the JAX package (~16 s on a CPU),
    which chip_smoke.py holds the port's build on the card against:

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_quotient import \\
            write_standard_reference as w; w()"
    """
    from plonky2_tpu.models.hash_tree import build_hash_tree_circuit
    from plonky2_tpu.plonk.config import CircuitConfig
    data, _, root = build_hash_tree_circuit(
        CircuitConfig.standard_recursion_config(), STANDARD_REF_LOG2_LEAVES)
    ints = lambda a: [int(x) for x in np.asarray(  # noqa: E731
        a, dtype=np.uint64).reshape(-1)]
    refs = {"log2_leaves": STANDARD_REF_LOG2_LEAVES,
            "degree_bits": int(data.common.degree_bits()),
            "circuit_digest": ints(data.prover_only.circuit_digest),
            "constants_sigmas_cap": [ints(d) for d in data.verifier_only
                                     .constants_sigmas_cap.digests],
            "root": ints(root)}
    with open(path, "w") as f:
        json.dump(refs, f, indent=1)
        f.write("\n")
    return refs


def _assert_programs_equal(a, b):
    for k, v in a.arrays().items():
        np.testing.assert_array_equal(v, b.arrays()[k], err_msg=k)
        assert np.asarray(v).dtype == np.asarray(b.arrays()[k]).dtype, k


def test_flagship_program_file_matches_jax_compiler(tmp_path):
    assert os.path.getsize(FLAGSHIP_NPZ) < 200_000
    stored, shape = cp.load(FLAGSHIP_NPZ)
    prog, port = write_flagship_program(str(tmp_path / "p.npz"))
    common = flagship_common()
    _assert_programs_equal(stored, port)
    assert shape == CircuitShape.from_common(common)
    assert (shape.degree_bits, shape.num_wires, shape.num_zs_pp) == \
        (18, 234, 20)
    assert stored.n_inputs == 343 and stored.n_regs == 822
    assert stored.n_ops == sum(stored.real_op_counts().values()) == 4045
    rng = np.random.default_rng(3)
    scal = [int(x) for x in rng.integers(0, P, size=prog.n_scalar_inputs,
                                         dtype=np.uint64)]
    np.testing.assert_array_equal(stored.scalar_bank(scal),
                                  prog.scalar_bank(scal))


def test_flagship_reference_file_matches_pickle():
    """The committed reference values of the flagship circuit and the
    program file's gate ids equal the pinned pickle's (what chip_smoke.py
    holds the port's build of the flagship against)."""
    assert os.path.getsize(FLAGSHIP_JSON) < 8_000
    with open(FLAGSHIP_JSON) as f:
        stored = json.load(f)
    common, refs = flagship_pickle()
    assert stored == refs
    assert (stored["degree_bits"], len(stored["constants_sigmas_cap"])) == \
        (18, 16)
    assert all(0 <= x < P for x in stored["circuit_digest"] + stored["root"])
    assert cp.load_gate_ids(FLAGSHIP_NPZ) == tuple(g.id()
                                                   for g in common.gates)


def random_program(seed: int, n_in: int = 7, n_ops: int = 300,
                   wave_width: int = 16):
    """A JAX-compiled program of random ops of every opcode."""
    rng = np.random.default_rng(seed)
    b = ProgramBuilder()
    alg = ExprAlgebra(b)
    pool = [b.vector_input() for _ in range(n_in)]
    scalars = [b.scalar_input() for _ in range(3)]
    scalars.append(alg.add(alg.mul(scalars[0], scalars[1]),
                           alg.const(int(rng.integers(2, P, dtype=np.uint64)))))
    for _ in range(n_ops):
        x, y, z = (pool[int(i)] for i in rng.integers(0, len(pool), 3))
        s = scalars[int(rng.integers(0, len(scalars)))]
        kind = int(rng.integers(0, 8))
        out = [alg.add(x, y), alg.sub(x, y), alg.mul(x, y), alg.add(x, s),
               alg.sub(s, x), alg.mul(x, s), alg.add(alg.mul(x, y), z),
               alg.add(alg.mul(x, s), z)][kind]
        if out.kind == "v":
            pool.append(out)
    for ev in pool[-12:]:
        b.mark_output(ev)
    return b.compile(wave_width=wave_width)


def _jax_runs(prog, inputs, scal):
    """run_numpy, jax_chunk_runner and the Pallas kernel in interpret mode
    (lanes a multiple of 128)."""
    bank = prog.scalar_bank(scal)
    want = prog.run_numpy(inputs, scal)
    C = inputs.shape[-1]
    regs = jnp.zeros((prog.n_regs, 2, C), jnp.uint32)
    regs = regs.at[:prog.n_inputs].set(
        jnp.asarray(np.stack(gfj.from_u64(inputs), axis=1)))
    bank_pair = np.stack(gfj.from_u64(bank), axis=1)
    out = np.asarray(prog.jax_chunk_runner()(regs, jnp.asarray(bank_pair)))
    jax_out = gfj.to_u64((out[:, 0], out[:, 1]))
    return bank, want, jax_out


@pytest.mark.parametrize("seed,wave_width", [(0, 16), (1, 4), (2, 32)])
def test_run_plain_matches_jax_on_random_programs(seed, wave_width):
    jprog = random_program(seed, wave_width=wave_width)
    prog = cp.program_from_arrays(jprog)
    assert cp.in_wave_reuse(prog)
    rng = np.random.default_rng(seed)
    inputs = rng.integers(0, P, size=(prog.n_inputs, 256), dtype=np.uint64)
    inputs[:, :128] = BOUNDARY[rng.integers(0, 5, size=(prog.n_inputs, 128))]
    scal = [int(x) for x in rng.integers(0, P, size=3, dtype=np.uint64)]
    bank, want, jax_out = _jax_runs(jprog, inputs, scal)
    np.testing.assert_array_equal(prog.scalar_bank(scal), bank)
    np.testing.assert_array_equal(jax_out, want)
    got = prog.run_plain(from_u64(inputs), from_u64(bank))
    np.testing.assert_array_equal(to_u64(got), want)
    # the K6 wrapper takes the plain version for a CPU tensor, handed all
    # inputs or only the rows its linear form reads
    x = from_u64(inputs)
    rows = torch.from_numpy(cp.linearize(prog).input_rows.astype(np.int64))
    for given in (x, x[rows]):
        np.testing.assert_array_equal(
            to_u64(run_program_cuda(prog, given, from_u64(bank))), want)


def test_pallas_interpret_matches_run_plain():
    jprog = random_program(5, n_in=4, n_ops=60, wave_width=8)
    prog = cp.program_from_arrays(jprog)
    rng = np.random.default_rng(5)
    inputs = rng.integers(0, P, size=(prog.n_inputs, 128), dtype=np.uint64)
    inputs[:, :8] = BOUNDARY[rng.integers(0, 5, size=(prog.n_inputs, 8))]
    scal = [int(x) for x in rng.integers(0, P, size=3, dtype=np.uint64)]
    bank = jprog.scalar_bank(scal)
    run = jprog.pallas_chunk_runner(tile=128, interpret=True)
    bank_i32 = np.stack(gfj.from_u64(bank), axis=1).view(np.int32)
    out = np.asarray(run(jnp.asarray(np.stack(gfj.from_u64(inputs))),
                         jnp.asarray(bank_i32)))
    got = prog.run_plain(from_u64(inputs), from_u64(bank))
    np.testing.assert_array_equal(to_u64(got), gfj.to_u64((out[0], out[1])))


def test_fib_quotient_program_matches_jax():
    r = fib_round()
    common, prover_only = r.data.common, r.data.prover_only
    jprog = build_quotient_program(common)
    prog = cp.program_from_arrays(jprog)
    inputs = host_quotient_inputs(common, prover_only, r.wires, r.zspp_c)
    scal = jax_scalar_inputs(r.pih, r.betas, r.gammas, r.alphas)
    assert quotient_scalar_inputs(r.pih, r.betas, r.gammas, r.alphas) == scal
    bank, want, jax_out = _jax_runs(jprog, inputs, scal)
    np.testing.assert_array_equal(jax_out, want)
    np.testing.assert_array_equal(prog.scalar_bank(scal), bank)
    got = prog.run_plain(from_u64(inputs), from_u64(bank))
    np.testing.assert_array_equal(to_u64(got), want)


def test_save_load_round_trip(tmp_path):
    prog = cp.program_from_arrays(random_program(3))
    shape = CircuitShape.from_common(fib_round().data.common)
    path = str(tmp_path / "prog.npz")
    cp.save(path, prog, shape)
    back, back_shape = cp.load(path)
    _assert_programs_equal(back, prog)
    assert back_shape == shape
    cp.save(path, prog)
    assert cp.load(path)[1] is None


@pytest.mark.parametrize("chunk", [None, 64])
def test_device_quotient_matches_jax_host_prover(chunk):
    """The port's commitments of the fibonacci witness -> the port's
    partial products -> DeviceQuotient.compute == the JAX host prover's
    quotient coefficients (_compute_quotient_polys)."""
    r = fib_round()
    common, prover_only = r.data.common, r.data.prover_only
    shape = CircuitShape.from_common(common)
    prog = cp.program_from_arrays(build_quotient_program(common))
    cs = PolynomialBatch.from_coeffs(
        prover_only.constants_sigmas_commitment.polynomials, shape.rate_bits,
        False, shape.cap_height, device="cpu")
    wires = PolynomialBatch.from_values(r.witness, shape.rate_bits, False,
                                        shape.cap_height, device="cpu")
    zspp = tpp.device_partial_products(
        from_u64(r.witness), from_u64(prover_only.sigmas.T.copy()), r.betas,
        r.gammas, shape)
    zspp_batch = PolynomialBatch.from_values(zspp, shape.rate_bits, False,
                                             shape.cap_height, device="cpu")
    dq = DeviceQuotient(shape, prog, cs, chunk=chunk, device="cpu")
    coeffs = dq.compute(wires, zspp_batch, r.pih, r.betas, r.gammas,
                        r.alphas)
    np.testing.assert_array_equal(to_u64(coeffs), r.expected)
    # the gathered inputs equal the JAX package's host input matrix, made
    # from its own commitments of the same values
    np.testing.assert_array_equal(
        to_u64(dq.gather(slice(None), wires, zspp_batch)),
        host_quotient_inputs(common, prover_only, r.wires, r.zspp_c))


def _to_jax_program(prog):
    """The JAX package's ConstraintProgram holding a port program."""
    from plonky2_tpu.plonk.constraint_program import \
        ConstraintProgram as JaxProgram
    snodes = []
    for kind, a, b, k in zip(prog.tape_kind, prog.tape_a, prog.tape_b,
                             prog.tape_const):
        op = cp.TAPE_KINDS[kind]
        snodes.append((op, int(k)) if op == "k" else (op, int(a)) if
                      op == "in" else (op, int(a), int(b)))
    return JaxProgram(
        n_inputs=prog.n_inputs, n_regs=prog.n_regs,
        wave_width=prog.wave_width, wave_opcodes=prog.wave_opcodes,
        wave_dst=prog.wave_dst, wave_a=prog.wave_a, wave_b=prog.wave_b,
        wave_c=prog.wave_c, out_regs=prog.out_regs, snodes=snodes,
        bank_sids=[int(s) for s in prog.bank_sids],
        n_scalar_inputs=prog.n_scalar_inputs, n_ops=prog.n_ops)


@pytest.mark.parametrize("seed", [0, 1])
def test_port_random_program_matches_run_numpy(seed):
    """The generated programs chip_smoke.py holds K6 to, run here by the
    JAX package's interpreter."""
    rng = np.random.default_rng(seed)
    prog = cp.random_program(rng)
    assert cp.in_wave_reuse(prog)
    inputs = rng.integers(0, P, size=(prog.n_inputs, 64), dtype=np.uint64)
    inputs[:, :32] = BOUNDARY[rng.integers(0, 5, size=(prog.n_inputs, 32))]
    scal = [int(x) for x in rng.integers(0, P, size=2, dtype=np.uint64)]
    jprog = _to_jax_program(prog)
    bank = prog.scalar_bank(scal)
    np.testing.assert_array_equal(bank, jprog.scalar_bank(scal))
    np.testing.assert_array_equal(
        to_u64(prog.run_plain(from_u64(inputs), from_u64(bank))),
        jprog.run_numpy(inputs, scal))


def test_quotient_round_matches_jax_host_prover():
    """The whole round on the CPU: Z/PP values, Z/PP commitment, quotient
    coefficients and quotient commitment equal the JAX host prover's."""
    from plonky2_tpu.fri.oracle import PolynomialBatch as JaxBatch
    from plonky2_tpu_torch.plonk.prover import quotient_round
    r = fib_round()
    common, prover_only = r.data.common, r.data.prover_only
    shape = CircuitShape.from_common(common)
    prog = cp.program_from_arrays(build_quotient_program(common))
    cs = PolynomialBatch.from_coeffs(
        prover_only.constants_sigmas_commitment.polynomials, shape.rate_bits,
        False, shape.cap_height, device="cpu")
    wires = PolynomialBatch.from_values(r.witness, shape.rate_bits, False,
                                        shape.cap_height, device="cpu")
    out = quotient_round(r.witness, wires, prover_only.sigmas.T.copy(), shape,
                         prog, cs, r.pih, r.betas, r.gammas, r.alphas,
                         device="cpu")
    np.testing.assert_array_equal(to_u64(out.zspp_values), r.zspp)
    np.testing.assert_array_equal(out.zspp_batch.merkle_tree.cap.digests,
                                  r.zspp_c.merkle_tree.cap.digests)
    np.testing.assert_array_equal(to_u64(out.quotient_coeffs), r.expected)
    chunks = r.expected.reshape(shape.num_quotient_polys, shape.degree)
    ref = JaxBatch.from_coeffs(chunks, shape.rate_bits, False,
                               shape.cap_height, use_device=False,
                               hasher=common.hasher())
    np.testing.assert_array_equal(out.quotient_batch.merkle_tree.cap.digests,
                                  ref.merkle_tree.cap.digests)
    np.testing.assert_array_equal(out.quotient_batch.leaves, ref.leaves)
