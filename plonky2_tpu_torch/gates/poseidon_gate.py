"""PoseidonGate: one width-12 permutation in one row (the port's copy of
plonky2_tpu/gates/poseidon_gate.py; reference
plonky2/src/gates/poseidon.rs).

Wire layout: 12 inputs | 12 outputs | swap | 4 deltas | 36 S-box inputs of
full rounds 1-3 | 22 partial-round S-box inputs | 48 S-box inputs of the
last 4 full rounds = 135 wires.  The constraints follow the fast
partial-round schedule (hash/poseidon_schedule.py), as the reference's do.
The generator computes a batch of rows with the numpy permutation of
hash/poseidon.py on a (G, 12) state: every S-box input of the naive
schedule is the fast schedule's too.
"""
from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..hash import poseidon as pos
from ..hash import poseidon_schedule as ps
from ..iop.generator import SimpleGenerator
from ..plonk.algebra import ScalarBase
from .gate import Gate

WIDTH = ps.WIDTH
HALF = ps.HALF_N_FULL_ROUNDS
NPR = ps.N_PARTIAL_ROUNDS


def wire_input(i):
    return i


def wire_output(i):
    return WIDTH + i


WIRE_SWAP = 2 * WIDTH
START_DELTA = 2 * WIDTH + 1


def wire_delta(i):
    assert i < 4
    return START_DELTA + i


START_FULL_0 = START_DELTA + 4


def wire_full_sbox_0(round, i):
    assert 0 < round < HALF
    return START_FULL_0 + WIDTH * (round - 1) + i


START_PARTIAL = START_FULL_0 + WIDTH * (HALF - 1)


def wire_partial_sbox(round):
    assert round < NPR
    return START_PARTIAL + round


START_FULL_1 = START_PARTIAL + NPR


def wire_full_sbox_1(round, i):
    assert round < HALF
    return START_FULL_1 + WIDTH * round + i


def wires_end():
    return START_FULL_1 + WIDTH * HALF


class PoseidonGate(Gate):
    def id(self):
        return ("PoseidonGate(PhantomData<plonky2_field::goldilocks_field::"
                f"GoldilocksField>)<WIDTH={WIDTH}>")

    def eval_unfiltered(self, alg, vars):
        constraints = []
        w = vars.local_wires

        swap = w[WIRE_SWAP]
        constraints.append(alg.mul(swap, alg.add_const(swap, gl.P - 1)))

        for i in range(4):
            delta_i = w[wire_delta(i)]
            diff = alg.sub(w[wire_input(i + 4)], w[wire_input(i)])
            constraints.append(alg.sub(alg.mul(swap, diff), delta_i))

        state = [None] * WIDTH
        for i in range(4):
            delta_i = w[wire_delta(i)]
            state[i] = alg.add(w[wire_input(i)], delta_i)
            state[i + 4] = alg.sub(w[wire_input(i + 4)], delta_i)
        for i in range(8, WIDTH):
            state[i] = w[wire_input(i)]

        round_ctr = 0
        for r in range(HALF):
            state = ps.constant_layer(alg, state, round_ctr)
            if r != 0:
                for i in range(WIDTH):
                    sbox_in = w[wire_full_sbox_0(r, i)]
                    constraints.append(alg.sub(state[i], sbox_in))
                    state[i] = sbox_in
            state = ps.sbox_layer(alg, state)
            state = ps.mds_layer(alg, state)
            round_ctr += 1

        state = ps.partial_first_constant_layer(alg, state)
        state = ps.mds_partial_layer_init(alg, state)
        for r in range(NPR - 1):
            sbox_in = w[wire_partial_sbox(r)]
            constraints.append(alg.sub(state[0], sbox_in))
            s0 = ps.sbox_monomial(alg, sbox_in)
            s0 = alg.add_const(s0, int(ps.FAST_PARTIAL_ROUND_CONSTANTS[r]))
            state = ps.mds_partial_layer_fast(alg, [s0] + state[1:], r)
        sbox_in = w[wire_partial_sbox(NPR - 1)]
        constraints.append(alg.sub(state[0], sbox_in))
        s0 = ps.sbox_monomial(alg, sbox_in)
        state = ps.mds_partial_layer_fast(alg, [s0] + state[1:], NPR - 1)
        round_ctr += NPR

        for r in range(HALF):
            state = ps.constant_layer(alg, state, round_ctr)
            for i in range(WIDTH):
                sbox_in = w[wire_full_sbox_1(r, i)]
                constraints.append(alg.sub(state[i], sbox_in))
                state[i] = sbox_in
            state = ps.sbox_layer(alg, state)
            state = ps.mds_layer(alg, state)
            round_ctr += 1

        for i in range(WIDTH):
            constraints.append(alg.sub(state[i], w[wire_output(i)]))

        return constraints

    def generators(self, row, local_constants):
        return [PoseidonGenerator(row)]

    def num_wires(self):
        return wires_end()

    def num_constants(self):
        return 0

    def degree(self):
        return 7

    def num_constraints(self):
        return 1 + 4 + WIDTH * (HALF - 1) + NPR + WIDTH * HALF + WIDTH


def _output_columns() -> np.ndarray:
    """The wire of each column of run_batch's output, in output_targets'
    order."""
    outs = [wire_delta(i) for i in range(4)]
    for r in range(1, HALF):
        outs += [wire_full_sbox_0(r, i) for i in range(WIDTH)]
    outs += [wire_partial_sbox(r) for r in range(NPR)]
    for r in range(HALF):
        outs += [wire_full_sbox_1(r, i) for i in range(WIDTH)]
    outs += [wire_output(i) for i in range(WIDTH)]
    return np.array(outs, dtype=np.int64)


OUTPUT_WIRES = _output_columns()
# the wire of each of run_batch's inputs, in dependencies' order
DEP_WIRES = np.array([wire_input(i) for i in range(WIDTH)] + [WIRE_SWAP],
                     dtype=np.int64)


class PoseidonGenerator(SimpleGenerator):
    batch_group = "poseidon"
    # rows per batch: the (G, 12) temporaries stay in cache
    batch_chunk = 1 << 12

    def __init__(self, row):
        self.row = row

    def dependencies(self):
        deps = [("w", self.row, wire_input(i)) for i in range(WIDTH)]
        deps.append(("w", self.row, WIRE_SWAP))
        return deps

    def output_targets(self):
        return [("w", self.row, int(c)) for c in OUTPUT_WIRES]

    @classmethod
    def target_indices(cls, gens, num_wires, degree):
        rows = np.fromiter((g.row for g in gens), dtype=np.int64,
                           count=len(gens))[:, None] * num_wires
        return rows + DEP_WIRES, rows + OUTPUT_WIRES

    @classmethod
    def run_batch(cls, gens, dep_vals):
        """(G, 13) inputs and swap -> (G, 122) wires: the permutation of
        G rows at once, on (G, 12) numpy states, recording each S-box
        input."""
        inputs = np.array(dep_vals[:, :WIDTH], dtype=np.uint64)
        swap = dep_vals[:, WIDTH]
        if not np.all((swap == 0) | (swap == 1)):
            raise ValueError("a Poseidon gate's swap wire is not 0 or 1")
        cols = [gl.mul(swap[:, None],
                       gl.sub(inputs[:, 4:8], inputs[:, 0:4]))]
        do_swap = (swap == 1)[:, None]
        inputs[:, :8] = np.where(do_swap,
                                 np.concatenate([inputs[:, 4:8],
                                                 inputs[:, 0:4]], axis=1),
                                 inputs[:, :8])
        rc = pos.ALL_ROUND_CONSTANTS.reshape(-1, WIDTH)
        state = inputs
        for r in range(2 * HALF + NPR):
            state = gl.add(state, rc[r])
            if pos.is_full_round(r):
                if r != 0:
                    cols.append(state)
                state = pos._sbox_np(state)
            else:
                cols.append(state[:, :1])
                state = np.concatenate([pos._sbox_np(state[:, :1]),
                                        state[:, 1:]], axis=1)
            state = pos._mds_np(state)
        cols.append(state)
        return np.concatenate(cols, axis=1)

    @classmethod
    def run_waves_device(cls, values, dep, out, offsets, err):
        """A run of consecutive waves on the device witness plan's slot
        buffer (wave v: the columns [offsets[v], offsets[v + 1]) of dep and
        out): one launch of kernel K7 on a CUDA tensor, its plain version on
        a CPU one (hash/poseidon_cuda.py:poseidon_wires_waves_cuda)."""
        from ..hash.poseidon_cuda import poseidon_wires_waves_cuda
        poseidon_wires_waves_cuda(values, dep, out, offsets, err)

    def run_once(self, witness, out):
        alg = ScalarBase()
        row = self.row
        w = lambda col: witness.get_target(("w", row, col))  # noqa: E731

        inputs = [w(wire_input(i)) for i in range(WIDTH)]
        swap = w(WIRE_SWAP)
        if swap not in (0, 1):
            raise ValueError("a Poseidon gate's swap wire is not 0 or 1")

        for i in range(4):
            delta = swap * (inputs[i + 4] - inputs[i]) % gl.P
            out.append((("w", row, wire_delta(i)), delta))

        if swap == 1:
            for i in range(4):
                inputs[i], inputs[i + 4] = inputs[i + 4], inputs[i]

        state = list(inputs)
        round_ctr = 0
        for r in range(HALF):
            state = ps.constant_layer(alg, state, round_ctr)
            if r != 0:
                for i in range(WIDTH):
                    out.append((("w", row, wire_full_sbox_0(r, i)),
                                state[i]))
            state = ps.sbox_layer(alg, state)
            state = ps.mds_layer(alg, state)
            round_ctr += 1

        state = ps.partial_first_constant_layer(alg, state)
        state = ps.mds_partial_layer_init(alg, state)
        for r in range(NPR - 1):
            out.append((("w", row, wire_partial_sbox(r)), state[0]))
            s0 = ps.sbox_monomial(alg, state[0])
            s0 = alg.add_const(s0, int(ps.FAST_PARTIAL_ROUND_CONSTANTS[r]))
            state = ps.mds_partial_layer_fast(alg, [s0] + state[1:], r)
        out.append((("w", row, wire_partial_sbox(NPR - 1)), state[0]))
        s0 = ps.sbox_monomial(alg, state[0])
        state = ps.mds_partial_layer_fast(alg, [s0] + state[1:], NPR - 1)
        round_ctr += NPR

        for r in range(HALF):
            state = ps.constant_layer(alg, state, round_ctr)
            for i in range(WIDTH):
                out.append((("w", row, wire_full_sbox_1(r, i)), state[i]))
            state = ps.sbox_layer(alg, state)
            state = ps.mds_layer(alg, state)
            round_ctr += 1

        for i in range(WIDTH):
            out.append((("w", row, wire_output(i)), state[i]))
