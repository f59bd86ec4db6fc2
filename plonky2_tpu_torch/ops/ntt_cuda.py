"""Wrappers for kernels K3 (DIT NTT), K4 (zero-tail DIT NTT) and K5 (DIF
NTT), in their column forms and the row forms the four-step schedule uses.

K3 replaces plonky2_tpu/ops/ntt_pallas.py:ntt_cols_pallas, K4
ntt_pallas.py:ntt_cols_zero_tail_pallas and K5 ntt_pallas.py:
ntt_cols_dif_pallas; their CUDA source is csrc/ntt.cu, whose header note
gives the bound on an H100 and the design of each form.  The column forms
transform down axis -2 of a (B, n1, n2) or (n1, n2) int64 batch, as the
TPU kernels do.  The row forms transform along axis -1, the contiguous
one, as the four-step schedule's second pass: ``ntt_rows_cuda`` (K3's,
natural order, stored transposed) and ``ntt_rows_dif_cuda`` (K5's,
bit-reversed order, in place).

Beyond the TPU kernels' contract, the column forms take optional fused
pointwise factors: ``pre`` multiplies the input (as loaded, natural order)
and ``post`` the output (as stored), each an int64 table of the input's or
output's 2-D shape, shared across the batch; K3's row form takes ``post``.
The plain versions apply them with gf.mul.

Each wrapper takes its plain version for a CPU tensor only; a CUDA tensor
launches the kernel or the call raises.  ``<wrapper>.launches`` counts
kernel launches.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..field import fft, gf
from ..field import goldilocks as gl
from ..field.convert import from_u64
from ..utils.bits import bit_reverse_indices, log2_strict

MAX_N1 = 8192        # column forms: n1 twiddles plus an n1-slot line fit
MAX_N2_ROWS = 8192   # row forms: n2 twiddles plus an n2-slot line fit
MAX_B_COLS = 65535   # column forms: one grid row per batch entry
_TILE_WORDS = 8192            # T * n1: a column block's tile
_ZERO_TAIL_TILE_WORDS = 4096  # T * Q with a zero tail (plus a prefix tile)


def ntt_cols(a: torch.Tensor, inverse: bool = False, pre=None,
             post=None) -> torch.Tensor:
    """Plain version of K3: size-n1 DIT NTT down the columns, natural order
    in and out, no 1/n scale on the inverse."""
    if pre is not None:
        a = gf.mul(a, pre)
    out = fft.dit(a.transpose(-1, -2), inverse).transpose(-1, -2)
    if post is not None:
        out = gf.mul(out, post)
    return out.contiguous()


def ntt_cols_zero_tail(a: torch.Tensor, rate_bits: int, pre=None,
                       post=None) -> torch.Tensor:
    """Plain version of K4: size-n1 DIT NTT down the columns of
    [a; zero rows], n1 = q * 2^rate_bits for a prefix of q rows, natural
    order in and out."""
    if pre is not None:
        a = gf.mul(a, pre)
    q = a.shape[-2]
    zeros = a.new_zeros((*a.shape[:-2], (q << rate_bits) - q, a.shape[-1]))
    return ntt_cols(torch.cat([a, zeros], dim=-2), post=post)


def ntt_cols_dif(a: torch.Tensor, zero_tail_rows: int = 0, pre=None,
                 post=None) -> torch.Tensor:
    """Plain version of K5: size-n1 DIF NTT down the columns of
    [a; zero_tail_rows zero rows], natural order in, bit-reversed out."""
    if pre is not None:
        a = gf.mul(a, pre)
    if zero_tail_rows:
        zeros = a.new_zeros((*a.shape[:-2], zero_tail_rows, a.shape[-1]))
        a = torch.cat([a, zeros], dim=-2)
    out = fft.dif(a.transpose(-1, -2)).transpose(-1, -2)
    if post is not None:
        out = gf.mul(out, post)
    return out.contiguous()


def ntt_rows(a: torch.Tensor, inverse: bool = False,
             post=None) -> torch.Tensor:
    """Plain version of K3's row form: size-n2 DIT NTT along the rows of
    (..., n1, n2), natural order in and out, no 1/n scale on the inverse,
    stored transposed: (..., n2, n1), times ``post`` (n2, n1)."""
    out = fft.dit(a, inverse).transpose(-1, -2)
    if post is not None:
        out = gf.mul(out, post)
    return out.contiguous()


def ntt_rows_dif(a: torch.Tensor) -> torch.Tensor:
    """Plain version of K5's row form: size-n2 DIF NTT along the rows,
    natural order in, bit-reversed out."""
    return fft.dif(a)


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, inverse: bool, device: str) -> torch.Tensor:
    return from_u64(fft.twiddle_table(n, inverse), device)


def zero_tail_factors_u64(n1: int, rate_bits: int) -> np.ndarray:
    """(n1,) factors that replace the first rate_bits DIF stages on a prefix
    of Q = n1 / 2^rate_bits rows followed by zeros: those stages leave slot
    c * Q + i holding prefix[i] * w_n1^(i * rev(c)), rev over rate_bits."""
    q = n1 >> rate_bits
    pw = gl.powers(gl.primitive_root_of_unity(log2_strict(n1)), n1)
    c = bit_reverse_indices(1 << rate_bits)
    return pw[(c[:, None] * np.arange(q)[None, :]) % n1].reshape(n1)


@functools.lru_cache(maxsize=None)
def _zero_tail_factors(n1: int, rate_bits: int, device: str) -> torch.Tensor:
    return from_u64(zero_tail_factors_u64(n1, rate_bits), device)


def _pow2_ceil(q: int) -> int:
    return 1 if q <= 1 else 1 << (q - 1).bit_length()


def tile_cols(q: int, n1: int, n2: int) -> int:
    """Columns per block of a column form: T * Q near the tile's words
    (Q = q rounded up to a power of two), T a power of two dividing n2."""
    big_q = _pow2_ceil(q)
    words = _ZERO_TAIL_TILE_WORDS if big_q < n1 else _TILE_WORDS
    t = max(1, words // big_q)
    while n2 % t:
        t //= 2
    return t


def _check_batch(a: torch.Tensor, what: str) -> None:
    kernels.check_field_tensor(a, "a")
    if a.dim() not in (2, 3):
        raise ValueError(f"a: expected (B, {what}, n2) or ({what}, n2), got "
                         f"{tuple(a.shape)}")


def _launch_cols(name: str, x: torch.Tensor, q: int, n1: int, inverse: bool,
                 pre, post, extra=(), factors=False) -> torch.Tensor:
    """Launch column entry `name` on x (B, q, n2) -> (B, n1, n2); `extra`
    are the entry's arguments between B and log_n1."""
    B, _, n2 = x.shape
    log_n1 = log2_strict(n1)
    if n1 > MAX_N1 or B > MAX_B_COLS:
        raise ValueError(f"{name}: n1 = {n1} (at most {MAX_N1}), B = {B} "
                         f"(at most {MAX_B_COLS})")
    dev = x.device
    kernels.check_kernel_operand(x, "a", dev)
    if pre is not None:
        kernels.check_kernel_operand(pre, "pre", dev, (q, n2))
    if post is not None:
        kernels.check_kernel_operand(post, "post", dev, (n1, n2))
    tw = _twiddles(n1, inverse, str(dev))
    out = torch.empty((B, n1, n2), dtype=torch.int64, device=dev)
    log_t = log2_strict(tile_cols(q, n1, n2))
    fac = ()
    if factors:     # the entry takes a factors table; none without a tail
        big_q = _pow2_ceil(q)
        fac = (None if big_q == n1 else _zero_tail_factors(
            n1, log2_strict(n1 // big_q), str(dev)).data_ptr(),)
    kernels.call(name, x.data_ptr(), out.data_ptr(), tw.data_ptr(), *fac,
                 kernels.ptr(pre), kernels.ptr(post), B, *extra, log_n1, n2,
                 log_t, dev.index, kernels.stream_of(x))
    return out


def _check_rows(name: str, x: torch.Tensor) -> None:
    """What a row form takes on the card: n2 <= MAX_N2_ROWS (its twiddles
    and one line in shared memory), powers of two, a contiguous batch."""
    B, n1, n2 = x.shape
    if n2 > MAX_N2_ROWS:
        raise ValueError(f"{name}: n2 = {n2} (at most {MAX_N2_ROWS})")
    log2_strict(n1)
    log2_strict(n2)
    kernels.check_kernel_operand(x, "a", x.device)


def ntt_cols_cuda(a: torch.Tensor, inverse: bool = False, pre=None,
                  post=None) -> torch.Tensor:
    """K3: (B, n1, n2) or (n1, n2) -> same shape, DIT down the columns."""
    _check_batch(a, "n1")
    if kernels.on_cpu(a):
        return ntt_cols(a, inverse, pre, post)
    x = a[None] if a.dim() == 2 else a
    n1 = x.shape[1]
    out = _launch_cols("plk_ntt_cols_dit", x, n1, n1, inverse, pre, post)
    ntt_cols_cuda.launches += 1
    return out[0] if a.dim() == 2 else out


ntt_cols_cuda.launches = 0


def ntt_cols_zero_tail_cuda(a: torch.Tensor, rate_bits: int, pre=None,
                            post=None) -> torch.Tensor:
    """K4: (B, q, n2) or (q, n2) prefix -> (B, q * 2^rate_bits, n2), DIT
    down the columns of [prefix; zero rows], natural order in and out."""
    _check_batch(a, "q")
    if rate_bits < 0:
        raise ValueError(f"rate_bits = {rate_bits}")
    if kernels.on_cpu(a):
        return ntt_cols_zero_tail(a, rate_bits, pre, post)
    x = a[None] if a.dim() == 2 else a
    q = x.shape[1]
    out = _launch_cols("plk_ntt_cols_zero_tail", x, q, q << rate_bits, False,
                       pre, post, (rate_bits,), factors=True)
    ntt_cols_zero_tail_cuda.launches += 1
    return out[0] if a.dim() == 2 else out


ntt_cols_zero_tail_cuda.launches = 0


def ntt_cols_dif_cuda(a: torch.Tensor, zero_tail_rows: int = 0, pre=None,
                      post=None) -> torch.Tensor:
    """K5: (B, q, n2) or (q, n2) -> (B, q + zero_tail_rows, n2), DIF down
    the columns with an implied zero tail, bit-reversed rows out."""
    _check_batch(a, "q")
    if kernels.on_cpu(a):
        return ntt_cols_dif(a, zero_tail_rows, pre, post)
    x = a[None] if a.dim() == 2 else a
    q = x.shape[1]
    out = _launch_cols("plk_ntt_cols_dif", x, q, q + zero_tail_rows, False,
                       pre, post, (q,), factors=True)
    ntt_cols_dif_cuda.launches += 1
    return out[0] if a.dim() == 2 else out


ntt_cols_dif_cuda.launches = 0


def ntt_rows_cuda(a: torch.Tensor, inverse: bool = False,
                  post=None) -> torch.Tensor:
    """K3's row form: (B, n1, n2) or (n1, n2) -> (B, n2, n1) or (n2, n1),
    DIT along the rows, natural order, stored transposed, times ``post``
    (n2, n1) where given."""
    _check_batch(a, "n1")
    if kernels.on_cpu(a):
        return ntt_rows(a, inverse, post)
    x = a[None] if a.dim() == 2 else a
    _check_rows("plk_ntt_rows_dit", x)
    B, n1, n2 = x.shape
    dev = x.device
    if post is not None:
        kernels.check_kernel_operand(post, "post", dev, (n2, n1))
    out = torch.empty((B, n2, n1), dtype=torch.int64, device=dev)
    kernels.call("plk_ntt_rows_dit", x.data_ptr(), out.data_ptr(),
                 _twiddles(n2, inverse, str(dev)).data_ptr(),
                 kernels.ptr(post), B, log2_strict(n1), log2_strict(n2),
                 dev.index, kernels.stream_of(x))
    ntt_rows_cuda.launches += 1
    return out[0] if a.dim() == 2 else out


ntt_rows_cuda.launches = 0


def ntt_rows_dif_cuda(a: torch.Tensor) -> torch.Tensor:
    """K5's row form, in place: (B, n1, n2) or (n1, n2), DIF along the
    rows, bit-reversed order out.  Returns ``a``, overwritten."""
    _check_batch(a, "n1")
    if kernels.on_cpu(a):
        return a.copy_(ntt_rows_dif(a))
    x = a[None] if a.dim() == 2 else a
    _check_rows("plk_ntt_rows_dif", x)
    B, n1, n2 = x.shape
    dev = x.device
    kernels.call("plk_ntt_rows_dif", x.data_ptr(),
                 _twiddles(n2, False, str(dev)).data_ptr(), B,
                 log2_strict(n1), log2_strict(n2), dev.index,
                 kernels.stream_of(x))
    ntt_rows_dif_cuda.launches += 1
    return a


ntt_rows_dif_cuda.launches = 0
