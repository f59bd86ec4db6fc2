"""A STARK's quotient, evaluated by its compiled constraint program on
kernel K6.

The JAX package evaluates a STARK's constraints over the quotient coset
with one numpy op per algebra op (plonky2_tpu/stark/prover.py:
_compute_quotient_polys, plonky2_tpu/evm/prover.py:_compute_quotient_polys).
The port traces the same ``eval`` (then the permutation checks and the
cross-table-lookup checks, where the table has them) through
``ExprAlgebra`` into a ``ConstraintProgram`` once per Stark object, and
runs it on K6 (plonk/constraint_program_cuda.py) over the coset in chunks
of lanes, as plonk/quotient_program.py:DeviceQuotient does for a circuit.
Field arithmetic is exact, so the values equal the JAX package's.

The program's vector inputs, in order, on the 2^(degree_bits + qdb)
quotient coset in natural order:

    trace columns at x, trace columns at g x, the permutation and CTL Z
    columns at x, the same at g x, L_first(x), L_last(x), x - g^-1,
    1 / Z_H(x)

and its scalar inputs: the alphas, each permutation challenge set's
(beta, gamma) pairs, the CTL challenges' (beta, gamma) pairs, the public
inputs (``quotient_scalars``).  So one program serves every proof; the
outputs are the num_challenges sums times 1 / Z_H(x).
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import numpy as np
import torch

from ..field import gf
from ..field import goldilocks as gl
from ..field.convert import from_u64
from ..ops import ntt
from ..plonk.constraint_program import (ConstraintProgram, ExprAlgebra,
                                        ProgramBuilder, linearize)
from ..plonk.constraint_program_cuda import run_program_cuda
from ..plonk.quotient_program import gather_rows
from ..utils.bits import bit_reverse_indices, log2_ceil
from .permutation import (PermutationChallenge, PermutationChallengeSet,
                          eval_permutation_checks)
from .stark import ConstraintConsumer, StarkEvaluationVars

GATHER_WORDS = 1 << 27      # input words a chunk of lanes gathers at most
N_DOMAIN = 4                # L_first, L_last, x - g^-1, 1 / Z_H


def num_permutation_zs(stark, config) -> int:
    return (stark.num_permutation_batches(config)
            if stark.uses_permutation_args() else 0)


def _column_key(col) -> tuple:
    return (tuple(col.linear_combination), col.constant)


def _ctl_key(ctl_zs) -> tuple:
    return tuple((tuple(_column_key(c) for c in cols),
                  None if filt is None else _column_key(filt), ch)
                 for cols, filt, ch in ctl_zs)


def build_stark_program(stark, config, ctl_zs: Sequence = ()
                        ) -> ConstraintProgram:
    """Trace the quotient of `stark` under `config` into a program.
    ``ctl_zs`` lists the table's CTL Z columns in prover order, each as
    (columns, filter column, index of its challenge)."""
    nch = config.num_challenges
    b = ProgramBuilder()
    alg = ExprAlgebra(b)
    n_perm = num_permutation_zs(stark, config)
    nz = n_perm + len(ctl_zs)
    local = [b.vector_input() for _ in range(stark.COLUMNS)]
    nxt = [b.vector_input() for _ in range(stark.COLUMNS)]
    zs = [b.vector_input() for _ in range(nz)]
    zs_next = [b.vector_input() for _ in range(nz)]
    l_first, l_last, z_last, zh_inv = (b.vector_input()
                                       for _ in range(N_DOMAIN))
    alphas = [b.scalar_input() for _ in range(nch)]

    def pair():
        beta = b.scalar_input()
        return beta, b.scalar_input()

    sets = [PermutationChallengeSet([PermutationChallenge(*pair())
                                     for _ in range(nch)])
            for _ in range(stark.permutation_batch_size() if n_perm else 0)]
    ctl_pairs = [pair() for _ in range(nch)] if ctl_zs else []
    pis = [b.scalar_input() for _ in range(stark.PUBLIC_INPUTS)]

    consumer = ConstraintConsumer(alg, alphas, z_last, l_first, l_last)
    vars = StarkEvaluationVars(local, nxt, pis)
    stark.eval(alg, vars, consumer)
    if n_perm:
        eval_permutation_checks(alg, stark, config, vars, zs[:n_perm],
                                zs_next[:n_perm], sets, consumer)
    if ctl_zs:
        from ..evm.cross_table_lookup import (CtlCheckVars,
                                              GrandProductChallenge,
                                              eval_cross_table_lookup_checks)
        eval_cross_table_lookup_checks(alg, vars, [
            CtlCheckVars(zs[n_perm + j], zs_next[n_perm + j],
                         GrandProductChallenge(*ctl_pairs[ch]), cols, filt)
            for j, (cols, filt, ch) in enumerate(ctl_zs)], consumer)
    for acc in consumer.accumulators():
        b.mark_output(alg.mul(acc, zh_inv))
    return b.compile()


def stark_program(stark, config, ctl_zs: Sequence = ()) -> ConstraintProgram:
    """``build_stark_program``, compiled once per Stark object and
    (number of challenges, CTL columns), and kept on the object."""
    cache = stark.__dict__.setdefault("_quotient_programs", {})
    key = (config.num_challenges, _ctl_key(ctl_zs))
    if key not in cache:
        cache[key] = build_stark_program(stark, config, ctl_zs)
    return cache[key]


def quotient_scalars(alphas, challenge_sets=None, ctl_challenges=None,
                     public_inputs=()) -> List[int]:
    """The program's scalar inputs for one proof, in its order."""
    out = [int(a) for a in alphas]
    for s in challenge_sets or ():
        for ch in s.challenges:
            out += [int(ch.beta), int(ch.gamma)]
    for ch in ctl_challenges or ():
        out += [int(ch.beta), int(ch.gamma)]
    return out + [int(p) for p in public_inputs]


@functools.lru_cache(maxsize=4)
def domain_columns(degree_bits: int, qdb: int, device: str) -> torch.Tensor:
    """(4, N) natural-order columns L_first(x), L_last(x), x - g^-1 and
    1 / Z_H(x) on the coset x = shift * w^i, N = 2^(degree_bits + qdb):
    the Lagrange bases of the subgroup's first and last points (h = 1 and
    h = g^-1: L_h(x) = h Z_H(x) / (n (x - h)))."""
    n = 1 << degree_bits
    N = n << qdb
    shift = gl.coset_shift()
    xs = gf.mul(from_u64(gl.two_adic_subgroup(degree_bits + qdb), device),
                torch.tensor(shift, dtype=torch.int64, device=device))
    v = gl.two_adic_subgroup(qdb)
    zh = gl.sub(gl.mul(v, np.uint64(pow(shift, n, gl.P))), np.uint64(1))
    zh_t = from_u64(np.tile(zh, N // zh.shape[0]), device)
    zh_inv = from_u64(np.tile(gl.inverse(zh), N // zh.shape[0]), device)
    last = gl.s_inv(gl.primitive_root_of_unity(degree_bits))

    def scalar(c):
        return torch.tensor(gf.as_i64(c % gl.P), dtype=torch.int64,
                            device=device)

    x_minus_last = gf.sub(xs, scalar(last))
    dens = torch.stack([gf.mul(gf.sub(xs, scalar(1)), scalar(n)),
                        gf.mul(x_minus_last, scalar(n))])
    inv = gf.inverse(dens)
    l_first = gf.mul(zh_t, inv[0])
    l_last = gf.mul(gf.mul(zh_t, inv[1]), scalar(last))
    return torch.stack([l_first, l_last, x_minus_last, zh_inv])


class StarkQuotient:
    """The quotient of one table's program at one degree on one device:
    the gather indices and domain columns, made once and reused by every
    proof (``quotient_context`` caches it)."""

    def __init__(self, program: ConstraintProgram, n_columns: int,
                 degree_bits: int, rate_bits: int, qdb: int, device):
        self.program = program
        self.device = torch.device(device)
        self.n_columns = n_columns
        self.n_zs = (program.n_inputs - 2 * n_columns - N_DOMAIN) // 2
        if qdb > rate_bits:
            raise ValueError("quotient degree exceeds the LDE rate")
        self.size = 1 << (degree_bits + qdb)
        full = 1 << (degree_bits + rate_bits)
        step = 1 << (rate_bits - qdb)
        perm = bit_reverse_indices(full)
        rows = np.arange(self.size, dtype=np.int64) * step
        # the next row is 2^qdb lanes on, as the JAX package's np.roll
        self.idx_nat = torch.from_numpy(perm[rows]).to(self.device)
        self.idx_next = torch.from_numpy(
            perm[(rows + (step << qdb)) % full]).to(self.device)
        self.dom = domain_columns(degree_bits, qdb, str(self.device))
        lin = linearize(program)
        self.rows = lin.input_rows.astype(np.int64)
        self.chunk = min(self.size, 1 << max(
            10, (GATHER_WORDS // max(1, lin.n_read)).bit_length() - 1))

    def gather(self, lanes: slice, trace_leaves, zs_leaves,
               out: torch.Tensor) -> torch.Tensor:
        """The rows the program reads, at natural-order `lanes`."""
        inat, inext = self.idx_nat[lanes], self.idx_next[lanes]
        nc, nz = self.n_columns, self.n_zs
        return gather_rows(((trace_leaves, nc, inat),
                            (trace_leaves, nc, inext),
                            (zs_leaves, nz, inat), (zs_leaves, nz, inext),
                            (self.dom[:, lanes], N_DOMAIN, None)),
                           self.rows, out)

    def evaluate(self, trace_batch, zs_batch, scalars) -> torch.Tensor:
        """(num_challenges, N) quotient values on the coset, natural
        order: gather, then K6, chunk by chunk."""
        prog = self.program
        bank = from_u64(prog.scalar_bank(scalars), self.device)
        C = self.chunk
        vals = torch.empty((prog.n_outputs, self.size), dtype=torch.int64,
                           device=self.device)
        inputs = torch.empty((len(self.rows), C), dtype=torch.int64,
                             device=self.device)
        zs_leaves = (zs_batch.leaves_dev if zs_batch is not None
                     else inputs[:0])
        for c in range(self.size // C):
            lanes = slice(c * C, (c + 1) * C)
            self.gather(lanes, trace_batch.leaves_dev, zs_leaves, inputs)
            vals[:, lanes] = run_program_cuda(prog, inputs, bank)
        return vals

    def compute(self, trace_batch, zs_batch, scalars) -> torch.Tensor:
        """(num_challenges * qdf, degree) quotient chunk coefficients."""
        vals = self.evaluate(trace_batch, zs_batch, scalars)
        coeffs = ntt.coset_intt(vals)
        degree = trace_batch.coeffs_dev.shape[-1]
        return coeffs.reshape(-1, degree)


@functools.lru_cache(maxsize=16)
def quotient_context(stark, program, degree_bits: int, rate_bits: int,
                     device: str) -> StarkQuotient:
    """The StarkQuotient of `stark`'s `program` at 2^degree_bits rows on
    `device`, made once."""
    return StarkQuotient(program, stark.COLUMNS, degree_bits, rate_bits,
                         log2_ceil(stark.quotient_degree_factor()), device)
