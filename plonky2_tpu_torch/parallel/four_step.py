"""Four-step (Bailey) NTT schedules over the column-NTT kernels, unsharded.

The port's counterpart of the single-device schedules in
plonky2_tpu/parallel/sharded_ntt.py: ``batched_four_step_ntt`` (with
``_four_step_pallas``), ``batched_four_step_zero_tail_ntt`` (with
``_four_step_zero_tail_pallas``) and ``batched_four_step_zero_tail_bitrev``
(with ``_four_step_zero_tail_bitrev_pallas``), and the step-2 twiddle tables
with their ``row_perm`` variant.  An n = n1 * n2 NTT of the (n1, n2) matrix
x[i1, i2] = c[i1 * n2 + i2] is: size-n1 NTTs down the columns, times
W[k1, i2] = w_n^(k1 * i2), size-n2 NTTs along the rows; output k2 * n1 + k1
is then at [k1, k2].  No pass copies the matrix to transpose it:

* natural order: pass 1 is K3 (or K4) down the columns, pass 2 K3's row
  form, which stores its tile transposed, [k2, k1], through shared memory;
* leaf (bit-reversed) order: pass 1 is K5 down the columns, whose output
  row r holds k1 = rev_n1(r), and pass 2 K5's row form in place, which
  puts k2 at rev_n2(k2); leaf rev_n(k2 * n1 + k1) = rev_n1(k1) * n2 +
  rev_n2(k2) is then where the value already lies.

The Goldilocks products the JAX package left to XLA between its kernels run
inside the kernels' fused ``pre``/``post`` factors: the coset shift in the
first pass's load, the step-2 twiddles (times 1/n for an inverse) in its
store.  Scaling between the passes instead of after the last one gives the
same field elements, since the NTT is linear.
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
    # output index k2 * n1 + k1 is stored at b[k2, k1]
    b = ntt_cuda.ntt_rows_cuda(
        a, inverse, post=None if post is None else post.reshape(n2, n1))
    return b.reshape(B, n)


def batched_four_step_zero_tail_ntt(prefix: torch.Tensor, rate_bits: int,
                                    pre=None) -> torch.Tensor:
    """(B, q) -> (B, q * 2^rate_bits): the NTT of [prefix, zeros] in
    natural order.  Step 1 is the zero-tail DIT column NTT (K4) on the
    (n1 / 2^r, n2) prefix rows, with ``pre`` (q,) in its load and the
    step-2 twiddles in its store; step 3 is K3's row form, which stores
    output k2 * n1 + k1 at b[k2, k1]."""
    B, q = prefix.shape
    m = q << rate_bits
    n1, n2 = _split(m, 1 << rate_bits)
    q_rows = n1 >> rate_bits
    tw = step2_twiddles(n1, n2, False, False, 1, str(prefix.device))
    a = ntt_cuda.ntt_cols_zero_tail_cuda(
        prefix.reshape(B, q_rows, n2), rate_bits,
        pre=None if pre is None else pre.reshape(q_rows, n2), post=tw)
    b = ntt_cuda.ntt_rows_cuda(a)
    return b.reshape(B, m)


def batched_four_step_zero_tail_bitrev(prefix: torch.Tensor, rate_bits: int,
                                       pre=None) -> torch.Tensor:
    """(B, q) -> (B, q * 2^rate_bits): the NTT of [prefix, zeros] in
    bit-reversed (Merkle-leaf) order.  Both passes are DIF (natural in,
    bit-reversed out): K5 down the columns with the zero tail and the
    row-permuted step-2 twiddles, then K5's row form in place, which leaves
    leaf rev_m(k2 * n1 + k1) = rev_n1(k1) * n2 + rev_n2(k2) where it
    belongs.  ``pre`` (q,) multiplies the prefix."""
    B, q = prefix.shape
    m = q << rate_bits
    n1, n2 = _split(m, 1 << rate_bits)
    q_rows = n1 >> rate_bits
    tw = step2_twiddles(n1, n2, False, True, 1, str(prefix.device))
    a = ntt_cuda.ntt_cols_dif_cuda(
        prefix.reshape(B, q_rows, n2), zero_tail_rows=n1 - q_rows,
        pre=None if pre is None else pre.reshape(q_rows, n2), post=tw)
    return ntt_cuda.ntt_rows_dif_cuda(a).reshape(B, m)
