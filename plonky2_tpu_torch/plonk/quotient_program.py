"""The quotient polynomials, evaluated by the compiled constraint program.

The port's counterpart of plonky2_tpu/plonk/quotient_program.py
(``build_quotient_program``, ``quotient_scalar_inputs``,
``DeviceQuotient``).  ``build_quotient_program`` traces
plonk/vanishing.py:eval_vanishing_poly (every gate's filtered constraints,
the copy-constraint terms, the alpha reduction, the 1/Z_H(x) factor) into
a constraint program, once a circuit.  The program's vector inputs are,
in order (JAX :11-14):

    [constants | sigmas] (cs oracle), wires, [zs | partial products]
    (Z/PP oracle), next zs (Z/PP oracle, rows shifted by one subgroup
    step), x, L_0(x), 1/Z_H(x)

on the 2^(degree_bits + quotient_degree_bits) quotient coset, in natural
order.  Its scalar inputs are the public-inputs hash (4), the betas, the
gammas and the alphas.  Its outputs are the num_challenges quotient rows.

The commitments' leaves are in bit-reversed order, so each chunk of lanes
gathers its columns through ``idx_nat``/``idx_next``, only the rows that
the program's linear form reads (``linearize(program).input_rows``), and
kernel K6 runs the program on them; the values go through ``coset_intt``
(K3) to coefficients.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..field import gf
from ..field import goldilocks as gl
from ..field.convert import from_u64
from ..ops import ntt
from ..utils.bits import bit_reverse_indices
from .algebra import EvaluationVars
from .constraint_program import (ConstraintProgram, ExprAlgebra,
                                 ProgramBuilder, linearize)
from .constraint_program_cuda import run_program_cuda
from .vanishing import eval_vanishing_poly


def build_quotient_program(common_data) -> ConstraintProgram:
    """The quotient's constraint program of a circuit (its
    CommonCircuitData), equal to the JAX compiler's (JAX :30-63)."""
    config = common_data.config
    nch = config.num_challenges
    b = ProgramBuilder()
    alg = ExprAlgebra(b)

    n_pre = common_data.num_preprocessed_polys()
    cs = [b.vector_input() for _ in range(n_pre)]
    wires = [b.vector_input() for _ in range(config.num_wires)]
    zspp = [b.vector_input()
            for _ in range(common_data.partial_products_range().stop)]
    next_zs = [b.vector_input() for _ in range(nch)]
    x = b.vector_input()
    l0 = b.vector_input()
    zh_inv = b.vector_input()

    pih = [b.scalar_input() for _ in range(4)]
    betas = [b.scalar_input() for _ in range(nch)]
    gammas = [b.scalar_input() for _ in range(nch)]
    alphas = [b.scalar_input() for _ in range(nch)]

    vars = EvaluationVars(cs[:common_data.num_constants], wires, pih)
    s_sigmas = [cs[j] for j in common_data.sigmas_range()]
    local_zs = [zspp[j] for j in common_data.zs_range()]
    partial_products = [zspp[j] for j in common_data.partial_products_range()]
    vals = eval_vanishing_poly(alg, common_data, x, vars, local_zs, next_zs,
                               partial_products, s_sigmas, betas, gammas,
                               alphas, l0)
    for v in vals:
        b.mark_output(alg.mul(v, zh_inv))
    return b.compile()


def quotient_scalar_inputs(public_inputs_hash, betas, gammas,
                           alphas) -> List[int]:
    return ([int(x) for x in public_inputs_hash] + [int(x) for x in betas]
            + [int(x) for x in gammas] + [int(x) for x in alphas])


def domain_columns(shape, device) -> torch.Tensor:
    """(3, N) natural-order columns x, L_0(x), 1/Z_H(x) on the quotient
    coset x = shift * w^i, N = 2^(degree_bits + quotient_degree_bits)."""
    qdb = shape.quotient_degree_bits
    N = 1 << (shape.degree_bits + qdb)
    shift = gl.coset_shift()
    xs = gf.mul(from_u64(gl.two_adic_subgroup(shape.degree_bits + qdb),
                         device), gf.as_i64(shift))
    # Z_H(x) = x^n - 1 takes the 2^qdb values shift^n * v^i - 1, in turn
    g_pow_n = pow(shift, shape.degree, gl.P)
    v = gl.two_adic_subgroup(qdb)
    zh = gl.sub(gl.mul(v, np.uint64(g_pow_n)), np.uint64(1))
    reps = N // zh.shape[0]
    zh_tiled = from_u64(np.tile(zh, reps), device)
    zh_inv = from_u64(np.tile(gl.inverse(zh), reps), device)
    n_x_minus_1 = gf.mul(gf.sub(xs, 1), gf.as_i64(shape.degree))
    l_0 = gf.mul(zh_tiled, gf.inverse(n_x_minus_1))
    return torch.stack([xs, l_0, zh_inv])


def gather_rows(sources, rows: np.ndarray,
                out: torch.Tensor) -> torch.Tensor:
    """Rows `rows` (sorted) of the inputs that `sources` stack, written
    into `out`: each source is (leaves, its row count, the leaf columns
    to take, or None for a matrix taken as it is).  One index_select a run
    of consecutive rows."""
    start = pos = 0
    for src, n, idx in sources:
        local = rows[(rows >= start) & (rows < start + n)] - start
        for run in (np.split(local, np.flatnonzero(np.diff(local) != 1) + 1)
                    if local.size else ()):
            r0, k = int(run[0]), len(run)
            if idx is None:
                out[pos:pos + k] = src[r0:r0 + k]
            else:
                torch.index_select(src[r0:r0 + k], 1, idx,
                                   out=out[pos:pos + k])
            pos += k
        start += n
    return out


class DeviceQuotient:
    """Per-circuit quotient context: the program, the resident cs leaves,
    the gather indices and the domain columns, made once and reused by
    every proof.  Runs on `device` (default cuda)."""

    def __init__(self, shape, program, cs_batch, chunk: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.shape = shape
        self.program = program
        nch = shape.num_challenges
        self.n_cols = (shape.num_preprocessed_polys, shape.num_wires,
                       shape.num_zs_pp, nch)
        if program.n_inputs != sum(self.n_cols) + 3:
            raise ValueError(f"program has {program.n_inputs} inputs, the "
                             f"shape gives {sum(self.n_cols) + 3}")
        if program.n_outputs != nch:
            raise ValueError(f"program has {program.n_outputs} outputs, "
                             f"expected {nch}")
        qdb = shape.quotient_degree_bits
        if qdb > shape.rate_bits:
            raise ValueError("quotient degree exceeds the LDE rate")
        N = 1 << (shape.degree_bits + qdb)
        self.lde_size = N
        self.chunk = N if chunk is None else chunk
        if N % self.chunk:
            raise ValueError(f"chunk {self.chunk} does not divide {N}")

        # natural-order lane i reads LDE row i * step, stored at leaf
        # column bitrev(i * step); Z(g x) is one subgroup step further
        full = 1 << (shape.degree_bits + shape.rate_bits)
        step = 1 << (shape.rate_bits - qdb)
        perm = bit_reverse_indices(full)
        rows = np.arange(N, dtype=np.int64) * step
        next_rows = (N >> shape.degree_bits) * step
        self.idx_nat = torch.from_numpy(perm[rows]).to(self.device)
        self.idx_next = torch.from_numpy(
            perm[(rows + next_rows) % full]).to(self.device)
        self.cs_leaves = cs_batch.leaves_dev.to(self.device)
        self.dom = domain_columns(shape, self.device)

    def gather(self, lanes, wires_batch, zspp_batch,
               out: torch.Tensor | None = None,
               rows: np.ndarray | None = None) -> torch.Tensor:
        """The program's inputs at natural-order `lanes` (a slice or an
        index tensor): all (n_inputs, C) of them, or the sorted input
        indices `rows` only, written into `out` if given."""
        inat, inext = self.idx_nat[lanes], self.idx_next[lanes]
        C = inat.shape[0]
        rows = (np.arange(self.program.n_inputs) if rows is None
                else np.asarray(rows, dtype=np.int64))
        if out is None:
            out = torch.empty((len(rows), C), dtype=torch.int64,
                              device=self.device)
        n_pre, n_wires, n_zspp, nch = self.n_cols
        z_leaves = zspp_batch.leaves_dev
        return gather_rows(((self.cs_leaves, n_pre, inat),
                            (wires_batch.leaves_dev, n_wires, inat),
                            (z_leaves, n_zspp, inat), (z_leaves, nch, inext),
                            (self.dom[:, lanes], 3, None)), rows, out)

    def scalar_bank(self, public_inputs_hash, betas, gammas,
                    alphas) -> torch.Tensor:
        return from_u64(self.program.scalar_bank(quotient_scalar_inputs(
            public_inputs_hash, betas, gammas, alphas)), self.device)

    def evaluate(self, wires_batch, zspp_batch, public_inputs_hash, betas,
                 gammas, alphas, chunk: int | None = None) -> torch.Tensor:
        """(num_challenges, N) quotient values on the coset, natural
        order: gather -> K6, chunk by chunk (of ``chunk`` lanes when
        given, else the context's)."""
        prog = self.program
        bank = self.scalar_bank(public_inputs_hash, betas, gammas, alphas)
        C = self.chunk if chunk is None else chunk
        if self.lde_size % C:
            raise ValueError(f"chunk {C} does not divide {self.lde_size}")
        vals = torch.empty((prog.n_outputs, self.lde_size), dtype=torch.int64,
                           device=self.device)
        rows = linearize(prog).input_rows
        inputs = torch.empty((len(rows), C), dtype=torch.int64,
                             device=self.device)
        for c in range(self.lde_size // C):
            lanes = slice(c * C, (c + 1) * C)
            self.gather(lanes, wires_batch, zspp_batch, out=inputs, rows=rows)
            vals[:, lanes] = run_program_cuda(prog, inputs, bank)
        return vals

    def compute(self, wires_batch, zspp_batch, public_inputs_hash, betas,
                gammas, alphas) -> torch.Tensor:
        """Quotient coefficient rows (num_challenges, N)."""
        return ntt.coset_intt(self.evaluate(wires_batch, zspp_batch,
                                            public_inputs_hash, betas,
                                            gammas, alphas))
