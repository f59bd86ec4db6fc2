"""Device commit pipeline: IFFT -> coset LDE in leaf order -> [salt rows] ->
Poseidon leaf hash -> Merkle levels.

The port's counterpart of plonky2_tpu/ops/commit.py (``commit_from_values``,
``commit_from_coeffs``, ``device_salt``).  Leaves are column-major (B[+4],
lde): leaf i is column i, already in bit-reversed order.  An H100 holds the
whole flagship leaf matrix (234 x 2^21 words, 3.9 GB), so all polynomials go
through each stage at once instead of the JAX package's 32-polynomial
blocks; the result is the same.
"""
from __future__ import annotations

import secrets

import numpy as np
import torch

from ..field import gf
from ..field import goldilocks as gl
from ..field.convert import from_u64
from ..hash import merkle_torch
from . import ntt


def _commit_coeffs(coeffs: torch.Tensor, rate_bits: int, cap_height: int,
                   salt=None):
    leaves = ntt.lde_coset_ntt_bitrev(coeffs, rate_bits)
    if salt is not None:
        leaves = torch.cat([leaves, salt])
    return leaves, merkle_torch.build_digest_levels(leaves, cap_height)


def commit_from_values(values: torch.Tensor, rate_bits: int, cap_height: int,
                       salt=None):
    """values (B, n) -> (coeffs (B, n), leaves (B[+4], n << rate_bits),
    digest levels)."""
    coeffs = ntt.ntt(values, inverse=True)
    leaves, levels = _commit_coeffs(coeffs, rate_bits, cap_height, salt)
    return coeffs, leaves, levels


def commit_from_coeffs(polys: torch.Tensor, rate_bits: int, cap_height: int,
                       salt=None):
    """coefficients (B, n) -> (leaves, digest levels)."""
    return _commit_coeffs(polys, rate_bits, cap_height, salt)


def device_salt(lde_size: int, device, seed: int | None = None,
                salt_rng: np.random.Generator | None = None) -> torch.Tensor:
    """(4, lde_size) blinding rows.

    With ``salt_rng`` the rows are drawn on the host in the JAX package's
    order (row-major (lde, 4), then transposed), so both packages salt
    alike.  Otherwise random 64-bit words from a seeded torch generator on
    the device, reduced by one conditional subtract of p."""
    if salt_rng is not None:
        salt = salt_rng.integers(0, gl.P, size=(lde_size, 4), dtype=np.uint64)
        return from_u64(salt.T.copy(), device)
    if seed is None:
        seed = secrets.randbits(63)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    bits = torch.randint(-(1 << 63), (1 << 63) - 1, (4, lde_size),
                         dtype=torch.int64, generator=g, device=device)
    return gf.canon(bits)
