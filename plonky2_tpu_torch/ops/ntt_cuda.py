"""Wrappers for kernels K3 (DIT column NTT), K4 (zero-tail DIT column NTT)
and K5 (DIF column NTT).

K3 replaces plonky2_tpu/ops/ntt_pallas.py:ntt_cols_pallas, K4
ntt_pallas.py:ntt_cols_zero_tail_pallas and K5 ntt_pallas.py:
ntt_cols_dif_pallas; their CUDA source is csrc/ntt.cu, whose header note
gives the bound on an H100 (HBM bytes) and the design.  All three transform
down axis -2 of a (B, n1, n2) or (n1, n2) int64 batch.

Beyond the TPU kernels' contract, all take optional fused pointwise factors:
``pre`` multiplies the input (as loaded, natural order) and ``post`` the
output (as stored), each an int64 table of the input's or output's (rows, n2)
shape, shared across the batch.  The plain versions apply them with gf.mul.

Each wrapper takes its plain version for a CPU tensor only; a CUDA tensor
launches the kernel or the call raises.  ``<wrapper>.launches`` counts
kernel launches.
"""
from __future__ import annotations

import functools

import torch

from .. import kernels
from ..field import fft, gf
from ..field.convert import from_u64
from ..utils.bits import log2_strict

MAX_N1 = 8192        # n1 twiddles plus an n1-row tile fit shared memory
_TILE_WORDS = 8192   # n1 * T target: a 64 KB tile


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


@functools.lru_cache(maxsize=None)
def _twiddles(n1: int, inverse: bool, device: str) -> torch.Tensor:
    return from_u64(fft.twiddle_table(n1, inverse), device)


def tile_cols(n1: int, n2: int) -> int:
    """Columns per block: n1 * T near 64 KB of words, T a power of two
    dividing n2."""
    t = max(1, _TILE_WORDS // n1)
    while n2 % t:
        t //= 2
    return t


def _launch(name: str, x: torch.Tensor, q: int, n1: int, inverse: bool,
            pre, post, extra=()) -> torch.Tensor:
    """Launch C entry `name` on x (B, q, n2) -> (B, n1, n2); `extra` are
    the entry's arguments between B and log_n1."""
    B, _, n2 = x.shape
    log_n1 = log2_strict(n1)
    if n1 > MAX_N1 or B > 65535:
        raise ValueError(f"{name}: n1 = {n1} (at most {MAX_N1}), B = {B} "
                         "(at most 65535)")
    dev = x.device
    kernels.check_kernel_operand(x, "a", dev)
    if pre is not None:
        kernels.check_kernel_operand(pre, "pre", dev, (q, n2))
    if post is not None:
        kernels.check_kernel_operand(post, "post", dev, (n1, n2))
    tw = _twiddles(n1, inverse, str(dev))
    out = torch.empty((B, n1, n2), dtype=torch.int64, device=dev)
    log_t = log2_strict(tile_cols(n1, n2))
    kernels.call(name, x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                 kernels.ptr(pre), kernels.ptr(post), B, *extra, log_n1, n2,
                 log_t, dev.index, kernels.stream_of(x))
    return out


def ntt_cols_cuda(a: torch.Tensor, inverse: bool = False, pre=None,
                  post=None) -> torch.Tensor:
    """K3: (B, n1, n2) or (n1, n2) -> same shape, DIT down the columns."""
    kernels.check_field_tensor(a, "a")
    if a.dim() not in (2, 3):
        raise ValueError(f"a: expected (B, n1, n2) or (n1, n2), got "
                         f"{tuple(a.shape)}")
    if kernels.on_cpu(a):
        return ntt_cols(a, inverse, pre, post)
    x = a[None] if a.dim() == 2 else a
    n1 = x.shape[1]
    out = _launch("plk_ntt_cols_dit", x, n1, n1, inverse, pre, post)
    ntt_cols_cuda.launches += 1
    return out[0] if a.dim() == 2 else out


ntt_cols_cuda.launches = 0


def ntt_cols_zero_tail_cuda(a: torch.Tensor, rate_bits: int, pre=None,
                            post=None) -> torch.Tensor:
    """K4: (B, q, n2) or (q, n2) prefix -> (B, q * 2^rate_bits, n2), DIT
    down the columns of [prefix; zero rows], natural order in and out."""
    kernels.check_field_tensor(a, "a")
    if a.dim() not in (2, 3):
        raise ValueError(f"a: expected (B, q, n2) or (q, n2), got "
                         f"{tuple(a.shape)}")
    if rate_bits < 0:
        raise ValueError(f"rate_bits = {rate_bits}")
    if kernels.on_cpu(a):
        return ntt_cols_zero_tail(a, rate_bits, pre, post)
    x = a[None] if a.dim() == 2 else a
    q = x.shape[1]
    out = _launch("plk_ntt_cols_zero_tail", x, q, q << rate_bits, False, pre,
                  post, (rate_bits,))
    ntt_cols_zero_tail_cuda.launches += 1
    return out[0] if a.dim() == 2 else out


ntt_cols_zero_tail_cuda.launches = 0


def ntt_cols_dif_cuda(a: torch.Tensor, zero_tail_rows: int = 0, pre=None,
                      post=None) -> torch.Tensor:
    """K5: (B, q, n2) or (q, n2) -> (B, q + zero_tail_rows, n2), DIF down
    the columns with an implied zero tail, bit-reversed rows out."""
    kernels.check_field_tensor(a, "a")
    if a.dim() not in (2, 3):
        raise ValueError(f"a: expected (B, q, n2) or (q, n2), got "
                         f"{tuple(a.shape)}")
    if kernels.on_cpu(a):
        return ntt_cols_dif(a, zero_tail_rows, pre, post)
    x = a[None] if a.dim() == 2 else a
    q = x.shape[1]
    out = _launch("plk_ntt_cols_dif", x, q, q + zero_tail_rows, False, pre,
                  post, (q,))
    ntt_cols_dif_cuda.launches += 1
    return out[0] if a.dim() == 2 else out


ntt_cols_dif_cuda.launches = 0
