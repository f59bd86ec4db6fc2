"""The linear form of a constraint program (plonky2_tpu_torch/plonk/
constraint_program.py:linearize), which kernel K6 runs, against the wave
program: ``run_plain_linear(linearize(prog))`` equals the port's
``run_plain`` and the JAX package's ``ConstraintProgram.run_numpy`` on the
flagship program, the fibonacci circuit's quotient program and random
programs that reuse registers inside a wave.  Exact equality."""
import os

import numpy as np
import pytest

from plonky2_tpu.plonk.quotient_program import build_quotient_program
from plonky2_tpu_torch.field.convert import from_u64, to_u64
from plonky2_tpu_torch.fri.oracle import PolynomialBatch
from plonky2_tpu_torch.plonk import constraint_program as cp
from plonky2_tpu_torch.plonk.circuit_shape import CircuitShape
from plonky2_tpu_torch.plonk.constraint_program_cuda import run_program_cuda
from plonky2_tpu_torch.plonk.quotient_program import DeviceQuotient
from tests.test_torch_partial_products import fib_round
from tests.test_torch_quotient import (BOUNDARY, FLAGSHIP_NPZ, P,
                                       _to_jax_program, random_program)


def _flagship():
    return cp.load(FLAGSHIP_NPZ)[0]


def _fib():
    return cp.program_from_arrays(build_quotient_program(
        fib_round().data.common))


def _port_random(W):
    prog = cp.random_program(np.random.default_rng(W), wave_width=W,
                             n_regs=3 * W)
    assert cp.in_wave_reuse(prog)
    return prog


def _jax_random(seed, W):
    prog = cp.program_from_arrays(random_program(seed, wave_width=W))
    assert cp.in_wave_reuse(prog)
    return prog


PROGRAMS = {
    "flagship": (_flagship, 192),
    "fibonacci": (_fib, 128),
    "random W=8": (lambda: _port_random(8), 64),
    "random W=16": (lambda: _port_random(16), 64),
    "random W=32": (lambda: _port_random(32), 64),
    "jax random W=16": (lambda: _jax_random(0, 16), 64),
    "wide (spills K6's shared memory)": (lambda: cp.wide_program(), 16),
}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_linear_form_matches_wave_program_and_jax(name):
    make, lanes = PROGRAMS[name]
    prog = make()
    lin = cp.linearize(prog)
    rng = np.random.default_rng(len(name))
    inputs = rng.integers(0, P, size=(prog.n_inputs, lanes), dtype=np.uint64)
    inputs[:, :lanes // 2] = BOUNDARY[rng.integers(
        0, 5, size=(prog.n_inputs, lanes // 2))]
    scal = [int(x) for x in rng.integers(0, P, size=prog.n_scalar_inputs,
                                         dtype=np.uint64)]
    bank = from_u64(prog.scalar_bank(scal))
    want = _to_jax_program(prog).run_numpy(inputs, scal)
    t_in = from_u64(inputs)
    np.testing.assert_array_equal(to_u64(prog.run_plain(t_in, bank)), want)
    np.testing.assert_array_equal(
        to_u64(cp.run_plain_linear(lin, t_in, bank)), want)
    # the rows it reads are enough, for the plain linear form and for the
    # K6 wrapper on a CPU tensor
    rows = from_u64(inputs[lin.input_rows])
    np.testing.assert_array_equal(
        to_u64(cp.run_plain_linear(lin, rows, bank)), want)
    np.testing.assert_array_equal(to_u64(run_program_cuda(prog, rows, bank)),
                                  want)


def _slot_reads(lin):
    """Per op, the slots it reads (keep stores excluded)."""
    f = lin.fields()
    out = []
    for code, a, b, c in zip(f["opcode"], f["a"], f["b"], f["c"]):
        ops = [a] + ([] if code in cp.SCALAR_B else [b]) + (
            [c] if code in (cp.MULADD, cp.MULADDS) else [])
        out.append([int(x) for x in ops if not x & cp.OPERAND_INPUT])
    return out


@pytest.mark.parametrize("name", ["flagship", "random W=16", "fibonacci",
                                  "wide (spills K6's shared memory)"])
def test_every_written_slot_is_read(name):
    """No op writes a dump slot: each op's result (and each kept input) is
    read by a later op before its slot is written again, or is an
    output."""
    lin = cp.linearize(PROGRAMS[name][0]())
    f = lin.fields()
    reads = _slot_reads(lin)
    outs = {int(o) for o in lin.out_operands if not o & cp.OPERAND_INPUT}
    pending = {}                 # slot -> written and not read yet
    for k in range(lin.n_ops):
        for s in reads[k]:
            pending.pop(s, None)
        kept = {int(lin.input_slot[x & cp.OPERAND_INDEX])
                for field in ("a", "b", "c")
                for x in [int(f[field][k])]
                if x & cp.OPERAND_KEEP and x & cp.OPERAND_INPUT and not
                (field == "b" and f["opcode"][k] in cp.SCALAR_B)}
        for s in kept:          # an input read twice by one op: one slot
            assert s not in pending, f"op {k} overwrites unread slot {s}"
            pending[s] = k
        d = int(f["dst"][k])
        assert d not in pending, f"op {k} overwrites unread slot {d}"
        pending[d] = k
    assert set(pending) <= outs


def test_flagship_linear_form():
    """The flagship program's 4,045 real ops, in at most 230 slots (the
    greedy schedule gives 211), reading 244 of its 343 inputs."""
    prog = _flagship()
    lin = cp.linearize(prog)
    assert lin.n_ops == prog.n_ops == 4045
    assert lin.n_slots <= 230
    assert 8 * lin.n_slots * 128 <= 232448       # 128 lanes a block fit
    assert prog.n_inputs == 343 and lin.n_read == 244
    f = lin.fields()
    assert sorted(np.bincount(f["opcode"], minlength=8).tolist()) == sorted(
        prog.real_op_counts().values())
    assert int(f["dst"].max()) < lin.n_slots
    assert cp.linearize(prog) is lin                    # cached
    again = cp.linearize(_flagship())                   # deterministic
    np.testing.assert_array_equal(again.ops, lin.ops)
    np.testing.assert_array_equal(again.input_slot, lin.input_slot)


def test_quotient_gathers_only_read_rows():
    """DeviceQuotient.gather of the linear form's rows equals those rows
    of the full input matrix (fibonacci circuit, CPU)."""
    r = fib_round()
    common, prover_only = r.data.common, r.data.prover_only
    shape = CircuitShape.from_common(common)
    prog = _fib()
    batch = lambda v: PolynomialBatch.from_values(  # noqa: E731
        v, shape.rate_bits, False, shape.cap_height, device="cpu")
    cs = PolynomialBatch.from_coeffs(
        prover_only.constants_sigmas_commitment.polynomials, shape.rate_bits,
        False, shape.cap_height, device="cpu")
    wires = batch(r.witness)
    zspp = batch(r.zspp)
    dq = DeviceQuotient(shape, prog, cs, device="cpu")
    full = dq.gather(slice(None), wires, zspp)
    rows = cp.linearize(prog).input_rows
    for sub in (rows, rows[::2], np.array([0, prog.n_inputs - 1])):
        np.testing.assert_array_equal(
            to_u64(dq.gather(slice(3, 40), wires, zspp, rows=sub)),
            to_u64(full[:, 3:40][sub]))


def _slot_uses(lin):
    """Reads and writes of each slot over the linear form: every op's
    destination and slot operands, each kept input's store, each output
    read from a slot."""
    f = lin.fields()
    count = np.zeros(lin.n_slots, dtype=np.int64)
    for k, reads in enumerate(_slot_reads(lin)):
        for s in reads + [int(f["dst"][k])]:
            count[s] += 1
    for s in lin.input_slot.tolist():
        if s >= 0:
            count[s] += 1
    for o in lin.out_operands.tolist():
        if not o & cp.OPERAND_INPUT:
            count[o] += 1
    return count


@pytest.mark.parametrize("name", ["flagship", "fibonacci",
                                  "wide (spills K6's shared memory)"])
def test_slots_are_numbered_busiest_first(name):
    """K6 keeps the lowest-numbered slots in shared memory when they do
    not all fit: linearize numbers them by use, most used first."""
    count = _slot_uses(cp.linearize(PROGRAMS[name][0]()))
    assert (np.diff(count) <= 0).all()
    assert count.min() >= 2               # a slot is written and read


def test_k6_forms():
    """The flagship program runs 128 lanes a block, every slot in shared
    memory; a wide program (1,452 slots, PERF.md) 32 lanes a block, 907
    slots in shared memory and the rest spilled; a bank larger than half
    of shared memory stays in device memory."""
    from plonky2_tpu_torch.plonk.constraint_program_cuda import (MAX_SHARED,
                                                                 k6_form)
    flag = cp.linearize(_flagship())
    f = k6_form(flag.n_slots, 857)
    assert (f.lanes, f.n_shared, f.n_spilled, f.bank_words) == (
        128, flag.n_slots, 0, 857)
    assert f.shared_bytes <= MAX_SHARED and f.blocks_per_sm() == 1
    assert k6_form(596, 872).lanes == 32 and k6_form(596, 872).n_spilled == 0
    assert k6_form(300, 872).lanes == 64
    wide = cp.wide_program()
    lin = cp.linearize(wide)
    assert lin.n_slots >= 1200
    f = k6_form(lin.n_slots, len(wide.bank_sids))
    assert (f.lanes, f.n_shared) == (32, (MAX_SHARED // 8 - 4) // 32)
    assert f.n_spilled == lin.n_slots - f.n_shared > 0
    assert f.shared_bytes <= MAX_SHARED
    big = k6_form(100, 28000)             # the bank does not fit beside
    assert (big.lanes, big.bank_words, big.n_shared, big.n_spilled) == (
        32, 0, 100, 0)


def _gate_mix():
    from plonky2_tpu_torch.models.gate_mix import build_gate_mix_circuit
    from plonky2_tpu_torch.plonk.quotient_program import \
        build_quotient_program
    data, _, _ = build_gate_mix_circuit(copies=1, device="cpu")
    return build_quotient_program(data.common)


def _keccak_table():
    """The EVM keccak table's quotient program (eval, then its CTL
    checks) under standard_fast_config: about 29,000 ops."""
    from plonky2_tpu_torch.evm import all_stark
    from plonky2_tpu_torch.evm.cross_table_lookup import ctl_zs_layout
    from plonky2_tpu_torch.stark.config import StarkConfig
    from plonky2_tpu_torch.stark.quotient_program import build_stark_program
    config = StarkConfig.standard_fast_config()
    return build_stark_program(all_stark.KeccakStark(), config, ctl_zs_layout(
        all_stark.all_cross_table_lookups(), all_stark.KECCAK, 2))


def _linear_sha256(lin) -> str:
    import hashlib
    h = hashlib.sha256()
    for a in (lin.ops, lin.input_rows, lin.input_slot, lin.out_operands):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(str(lin.n_slots).encode())
    return h.hexdigest()


# the linear forms as the list scheduler made them when it scanned the
# whole ready set for each pick; the heap that replaced the scan must make
# the same picks
LINEAR_FORM_SHA256 = {
    "flagship": "b2200c5a575fab50786be45dfb4c080f826020b1f6ae3b17090e782dab"
                "08e76c",
    "gate mix": "2bbb566d5248ab0fcee8f7dd2af0db66d36ad5ad46eb700f919299d173"
                "d192e0",
    "wide": "a18d4caa3f077052bb547c0a45c211f561ece1888c01a117418da0939ed09e"
            "a6",
}


@pytest.mark.parametrize("name,make", [("flagship", _flagship),
                                       ("gate mix", _gate_mix),
                                       ("wide", cp.wide_program)])
def test_linear_form_is_pinned(name, make):
    assert _linear_sha256(cp.linearize(make())) == LINEAR_FORM_SHA256[name]


def test_keccak_table_linearizes_in_seconds():
    """The keccak table's program (29,263 ops) linearizes in seconds, and
    its linear form equals the wave program on random lanes."""
    import time
    prog = _keccak_table()
    t = time.perf_counter()
    lin = cp.linearize(prog)
    assert time.perf_counter() - t < 10
    assert lin.n_ops == 29263 and lin.n_slots <= cp.MAX_SLOTS
    rng = np.random.default_rng(29)
    inputs = from_u64(rng.integers(0, P, size=(prog.n_inputs, 48),
                                   dtype=np.uint64))
    bank = from_u64(prog.scalar_bank([int(x) for x in rng.integers(
        0, P, size=prog.n_scalar_inputs, dtype=np.uint64)]))
    np.testing.assert_array_equal(to_u64(cp.run_plain_linear(lin, inputs,
                                                             bank)),
                                  to_u64(prog.run_plain(inputs, bank)))
