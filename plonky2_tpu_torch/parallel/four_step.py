"""Four-step (Bailey) NTT schedules over the column-NTT kernels, unsharded.

The port's counterpart of the single-device schedules in
plonky2_tpu/parallel/sharded_ntt.py: ``batched_four_step_ntt`` (with
``_four_step_pallas``) and ``batched_four_step_zero_tail_bitrev`` (with
``_four_step_zero_tail_bitrev_pallas``), and the step-2 twiddle tables with
their ``row_perm`` variant.  An n = n1 * n2 NTT is: column NTTs of size n1,
times W[k1, i2] = w_n^(k1 * i2), transpose, column NTTs of size n2.

The Goldilocks products the JAX package left to XLA between its kernels run
inside the kernels' fused ``pre``/``post`` factors: the coset shift in the
first pass's load, the step-2 twiddles (times 1/n for an inverse) in its
store.  Scaling between the passes instead of after the last one gives the
same field elements, since the NTT is linear.  The transposes are plain
``.transpose().contiguous()`` copies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import goldilocks as gl
from ..field.convert import from_u64
from ..ops import ntt_cuda
from ..utils.bits import bit_reverse_indices, log2_strict


@functools.lru_cache(maxsize=8)
def step2_twiddles(n1: int, n2: int, inverse: bool, row_perm: bool,
                   scale: int, device: str) -> torch.Tensor:
    """(n1, n2) table W[k1, i2] = w_n^(+-k1 * i2) * scale; with row_perm,
    row r carries k1 = bitrev_n1(r) (for the DIF pipeline's bit-reversed
    rows)."""
    n = n1 * n2
    g = gl.primitive_root_of_unity(log2_strict(n))
    pw = gl.powers(gl.s_inv(g) if inverse else g, n)
    k1 = bit_reverse_indices(n1) if row_perm else np.arange(n1)
    table = pw[(k1[:, None] * np.arange(n2)[None, :]) % n]
    if scale != 1:
        table = gl.mul(table, np.uint64(scale))
    return from_u64(table, device)


def _split(n: int, min_n1: int = 1):
    n1 = max(1 << (log2_strict(n) // 2), min_n1)
    return n1, n // n1


def batched_four_step_ntt(coeffs: torch.Tensor, inverse: bool = False,
                          pre=None, post=None) -> torch.Tensor:
    """(B, n) -> (B, n) natural-order NTT (inverse scaled by 1/n).
    ``pre`` (n,) multiplies the input, ``post`` (n,) the output."""
    B, n = coeffs.shape
    n1, n2 = _split(n)
    scale = gl.s_inv(n) if inverse else 1
    tw = step2_twiddles(n1, n2, inverse, False, scale, str(coeffs.device))
    a = ntt_cuda.ntt_cols_cuda(
        coeffs.reshape(B, n1, n2), inverse,
        pre=None if pre is None else pre.reshape(n1, n2), post=tw)
    # output index k2 * n1 + k1 sits at b[k2, k1]
    b = ntt_cuda.ntt_cols_cuda(
        a.transpose(1, 2).contiguous(), inverse,
        post=None if post is None else post.reshape(n2, n1))
    return b.reshape(B, n)


def batched_four_step_zero_tail_bitrev(prefix: torch.Tensor, rate_bits: int,
                                       pre=None) -> torch.Tensor:
    """(B, q) -> (B, q * 2^rate_bits): the NTT of [prefix, zeros] in
    bit-reversed (Merkle-leaf) order.  Both passes are DIF (natural in,
    bit-reversed out); leaf rev_m(k2 * n1 + k1) = rev_n1(k1) * n2 + rev_n2(k2)
    then needs one transpose.  ``pre`` (q,) multiplies the prefix."""
    B, q = prefix.shape
    m = q << rate_bits
    n1, n2 = _split(m, 1 << rate_bits)
    q_rows = n1 >> rate_bits
    tw = step2_twiddles(n1, n2, False, True, 1, str(prefix.device))
    a = ntt_cuda.ntt_cols_dif_cuda(
        prefix.reshape(B, q_rows, n2), zero_tail_rows=n1 - q_rows,
        pre=None if pre is None else pre.reshape(q_rows, n2), post=tw)
    b = ntt_cuda.ntt_cols_dif_cuda(a.transpose(1, 2).contiguous())
    return b.transpose(1, 2).contiguous().reshape(B, m)
