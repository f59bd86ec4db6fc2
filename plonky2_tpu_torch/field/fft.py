"""Radix-2 NTT over Goldilocks: stage twiddles and the plain torch oracle.

The port's counterpart of plonky2_tpu/field/fft_numpy.py.  ``fft(c)[i] ==
poly(g^i)`` for the canonical two-adic generator g, natural order; ``ifft``
is its exact inverse.  The last axis is the polynomial axis.  ``dit`` and
``dif`` are the butterfly networks the column-NTT kernels' plain versions
reuse (ops/ntt_cuda.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.bits import bit_reverse_indices, log2_strict
from . import gf
from . import goldilocks as gl
from .convert import from_u64


@functools.lru_cache(maxsize=None)
def stage_twiddles(n: int, inverse: bool = False):
    """twiddles[s] = powers of the 2^(s+1)-domain generator (or its
    inverse), length 2^s, as numpy uint64."""
    out = []
    for s in range(log2_strict(n)):
        g = gl.primitive_root_of_unity(s + 1)
        out.append(gl.powers(gl.s_inv(g) if inverse else g, 1 << s))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def twiddle_table(n: int, inverse: bool) -> np.ndarray:
    """All stages' twiddles in one (n,) uint64 array: stage s at
    [2^s - 1, 2^(s+1) - 1); the last slot is unused padding (kept so that
    n == 1 still gives a non-empty buffer)."""
    flat = np.zeros(n, dtype=np.uint64)
    for s, t in enumerate(stage_twiddles(n, inverse)):
        flat[(1 << s) - 1:(1 << (s + 1)) - 1] = t
    return flat


@functools.lru_cache(maxsize=None)
def _stage_tensors(n: int, inverse: bool, device: str):
    return tuple(from_u64(t, device) for t in stage_twiddles(n, inverse))


@functools.lru_cache(maxsize=None)
def _bitrev_tensor(n: int, device: str):
    return torch.from_numpy(bit_reverse_indices(n)).to(device)


def dit(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Radix-2 DIT NTT over the last axis, natural order in and out; the
    inverse swaps in inverse twiddles and does not scale by 1/n."""
    n = a.shape[-1]
    bits = log2_strict(n)
    tw = _stage_tensors(n, inverse, str(a.device))
    a = a[..., _bitrev_tensor(n, str(a.device))]
    batch = a.shape[:-1]
    for s in range(bits):
        half = 1 << s
        x = a.reshape(*batch, n // (2 * half), 2 * half)
        u = x[..., :half]
        v = gf.mul(x[..., half:], tw[s])
        a = torch.cat([gf.add(u, v), gf.sub(u, v)], dim=-1).reshape(*batch, n)
    return a


def dif(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Radix-2 DIF NTT over the last axis: natural order in, bit-reversed
    order out.  Stage s = bits-1 .. 0 maps (u, v) to (u + v, w_s (u - v))."""
    n = a.shape[-1]
    bits = log2_strict(n)
    tw = _stage_tensors(n, inverse, str(a.device))
    batch = a.shape[:-1]
    for s in range(bits - 1, -1, -1):
        half = 1 << s
        x = a.reshape(*batch, n // (2 * half), 2 * half)
        u, v = x[..., :half], x[..., half:]
        a = torch.cat([gf.add(u, v), gf.mul(gf.sub(u, v), tw[s])],
                      dim=-1).reshape(*batch, n)
    return a


def fft(coeffs: torch.Tensor) -> torch.Tensor:
    """values[i] = poly(g^i), natural order."""
    return dit(coeffs)


def ifft(values: torch.Tensor) -> torch.Tensor:
    n = values.shape[-1]
    return gf.mul(dit(values, inverse=True), gf.as_i64(gl.s_inv(n)))


def coset_fft(coeffs: torch.Tensor,
              shift: int = gl.MULTIPLICATIVE_GROUP_GENERATOR) -> torch.Tensor:
    """values[i] = poly(shift * g^i)."""
    n = coeffs.shape[-1]
    return fft(gf.mul(coeffs, from_u64(gl.powers(shift, n), coeffs.device)))
