"""Opened values: committed polynomials evaluated at extension points.

The port's counterpart of plonky2_tpu/ops/openings.py (``ext_powers_host``,
``eval_openings_batched``, ``eval_device_polys_ext``), as torch ops on the
commitments' resident coefficients: each value is the dot product of a
polynomial's base-field coefficients with the point's powers, taken
component by component (the powers' two coordinates), and summed with
``gf.modsum``.  Rows go through in chunks, so the temporaries stay near
``CHUNK_ELEMS`` words whatever the batch.  Only the (B, 2) values come back
to the host.  The JAX package computes this with XLA, outside Pallas, so no
kernel of its own replaces it.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..field import extension as ext
from ..field import gf
from ..field import gf2
from ..field.convert import to_u64

CHUNK_ELEMS = 1 << 24


def ext_powers(z, n: int, device) -> tuple:
    """[1, z, ..., z^(n-1)] as an extension pair of (n,) tensors:
    z^(a m + b) = z^(a m) z^b for m = 2^ceil(log2(n) / 2), from two host
    tables of about sqrt(n) powers and one product on the device."""
    m = 1 << ((max(n, 1) - 1).bit_length() + 1) // 2
    low = gf2.from_host(ext.powers(z, m), device)
    high = gf2.from_host(ext.powers(ext.s_exp(z, m), -(-n // m)), device)
    c0, c1 = gf2.mul2((high[0][:, None], high[1][:, None]),
                      (low[0][None], low[1][None]))
    return c0.reshape(-1)[:n], c1.reshape(-1)[:n]


def eval_polys_ext(coeffs: torch.Tensor, zpows) -> torch.Tensor:
    """coeffs (B, n) at each point whose powers are in `zpows` (a list of
    extension pairs of (n,) tensors) -> (B, len(zpows), 2) on the device."""
    B, n = coeffs.shape
    # (1, 2 * points, n): each point's two coordinates, in order
    zp = torch.stack([c for pair in zpows for c in pair])[None]
    rows = max(1, CHUNK_ELEMS // (n * zp.shape[1]))
    out = torch.empty((B, zp.shape[1]), dtype=torch.int64,
                      device=coeffs.device)
    for r in range(0, B, rows):
        out[r:r + rows] = gf.modsum(gf.mul(coeffs[r:r + rows, None], zp), -1)
    return out.reshape(B, len(zpows), 2)


def eval_device_polys_ext(coeffs: torch.Tensor, zpow) -> np.ndarray:
    """coeffs (B, n) at the point whose powers are `zpow` -> (B, 2) uint64
    on the host."""
    return to_u64(eval_polys_ext(coeffs, [zpow])[:, 0])


def eval_openings_batched(batches, points) -> List[List[np.ndarray]]:
    """Every polynomial of several commitments (PolynomialBatch) at several
    extension points, with one copy to the host: ``out[oracle][point]`` is
    (B, 2) uint64."""
    dev = batches[0].coeffs_dev.device
    n = batches[0].coeffs_dev.shape[-1]
    zpows = [ext_powers(p, n, dev) for p in points]
    vals = [eval_polys_ext(b.coeffs_dev, zpows) for b in batches]
    host = to_u64(torch.cat(vals))
    out, start = [], 0
    for v in vals:
        out.append([host[start:start + v.shape[0], p]
                    for p in range(len(points))])
        start += v.shape[0]
    return out
