"""Batched Goldilocks NTTs: plain, coset and low-degree extension.

The port's counterpart of plonky2_tpu/ops/ntt.py (``ntt``, ``coset_ntt``,
``coset_intt``, ``lde_coset_ntt``, ``lde_coset_ntt_bitrev``).  The last axis
is the polynomial axis (power of two); a 1-D input is one polynomial.  Every
size runs the four-step schedule (parallel/four_step.py), so on the card
every transform goes through kernels K3, K4 and K5; the coset shift rides
in the first pass's fused load factor.  Outputs equal the JAX package's bit
for bit.

The zero-tail transform (JAX ``_ntt_core_zero_tail``) is the first pass of
both LDEs: K4 (DIT) for the natural-order ``lde_coset_ntt``, K5 (DIF) for
the Merkle-leaf-order ``lde_coset_ntt_bitrev``.
"""
from __future__ import annotations

import functools

import torch

from ..field import goldilocks as gl
from ..field.convert import from_u64
from ..parallel import four_step

SHIFT = gl.MULTIPLICATIVE_GROUP_GENERATOR


@functools.lru_cache(maxsize=16)
def powers_table(base: int, n: int, device: str) -> torch.Tensor:
    """[1, base, ..., base^(n-1)] as an int64 tensor on `device`."""
    return from_u64(gl.powers(base, n), device)


def _batched(fn):
    """Apply a (B, n) -> (B, m) function to a 1-D or 2-D input."""
    @functools.wraps(fn)
    def wrapper(a: torch.Tensor, *args, **kwargs):
        if a.dim() == 1:
            return fn(a[None], *args, **kwargs)[0]
        if a.dim() != 2:
            raise ValueError(f"expected (n,) or (B, n), got {tuple(a.shape)}")
        return fn(a, *args, **kwargs)
    return wrapper


@_batched
def ntt(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """Evaluations on the 2^k-th roots of unity (inverse: interpolation)."""
    return four_step.batched_four_step_ntt(a, inverse)


@_batched
def coset_ntt(coeffs: torch.Tensor, shift: int = SHIFT) -> torch.Tensor:
    n = coeffs.shape[-1]
    pre = powers_table(shift, n, str(coeffs.device))
    return four_step.batched_four_step_ntt(coeffs, pre=pre)


@_batched
def coset_intt(values: torch.Tensor, shift: int = SHIFT) -> torch.Tensor:
    n = values.shape[-1]
    post = powers_table(gl.s_inv(shift), n, str(values.device))
    return four_step.batched_four_step_ntt(values, True, post=post)


@_batched
def lde_coset_ntt_bitrev(coeffs: torch.Tensor, rate_bits: int,
                         shift: int = SHIFT) -> torch.Tensor:
    """Coset LDE of the n coefficients on the n * 2^rate_bits domain, in
    bit-reversed (Merkle-leaf) order."""
    n = coeffs.shape[-1]
    pre = powers_table(shift, n, str(coeffs.device))
    return four_step.batched_four_step_zero_tail_bitrev(coeffs, rate_bits,
                                                        pre=pre)


@_batched
def lde_coset_ntt(coeffs: torch.Tensor, rate_bits: int,
                  shift: int = SHIFT) -> torch.Tensor:
    """Coset LDE of the n coefficients on the n * 2^rate_bits domain, in
    natural order."""
    n = coeffs.shape[-1]
    pre = powers_table(shift, n, str(coeffs.device))
    return four_step.batched_four_step_zero_tail_ntt(coeffs, rate_bits,
                                                     pre=pre)
