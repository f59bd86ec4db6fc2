"""The permutation argument's Z polynomials and partial products.

The port's counterpart of plonky2_tpu/ops/partial_products.py
(``_zs_pp_fn``, ``device_partial_products``), as plain torch ops: the JAX
package computes this phase with XLA, outside Pallas, so no kernel of its
own replaces it.  Per challenge (beta, gamma), over the routed wires:

    numer_i = w_i + beta * k_i * x + gamma,  denom_i = w_i + beta * s_i + gamma

multiplied in chunks of ``quotient_degree_factor`` wires (padded with
ones), the chunks' cumulative products, and Z, the exclusive running
product of the last cumulative product over the subgroup.

Field values are exact, so how the products are grouped cannot change a
bit.  Each chunk's quotient is taken as (product of numerators) times the
inverse of (product of denominators), and the chunks' inverses come from
one Fermat inverse per column (Montgomery's trick) instead of one per
wire: a Fermat inverse is 96 products, the trick three per chunk.  A zero
denominator gives the chunk 0, as the JAX package's inverse(0) == 0 does.
Z is a log-step doubling scan, as torch has no modular scan.  The result
equals the JAX package's bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import gf
from ..field import goldilocks as gl
from ..field.convert import from_u64


@functools.lru_cache(maxsize=4)
def k_times_subgroup(k_is: tuple, degree_bits: int,
                     device: str) -> torch.Tensor:
    """(len(k_is), degree) table k_i * g^j: the identity permutation's
    values on the coset k_i H."""
    sub = from_u64(gl.two_adic_subgroup(degree_bits), device)
    k = from_u64(np.asarray(k_is, dtype=np.uint64), device)
    return gf.mul(k[:, None], sub[None, :])


def _prod_rows(x: torch.Tensor) -> torch.Tensor:
    """Product over axis 0, in order."""
    acc = x[0]
    for row in x[1:]:
        acc = gf.mul(acc, row)
    return acc


def inverse_rows(x: torch.Tensor) -> torch.Tensor:
    """Elementwise inverses of x (rows, ...), inverse(0) == 0,
    with one Fermat inverse per column: prefix products down the rows,
    the inverse of the last, and the inverses unwound back up."""
    zero = x == 0
    d = torch.where(zero, torch.ones_like(x), x)
    prefix = [d[0]]
    for row in d[1:]:
        prefix.append(gf.mul(prefix[-1], row))
    inv = gf.inverse(prefix[-1])          # 1 / (d[0] * ... * d[-1])
    out = [None] * x.shape[0]
    for i in range(x.shape[0] - 1, 0, -1):
        out[i] = gf.mul(inv, prefix[i - 1])
        inv = gf.mul(inv, d[i])
    out[0] = inv
    return torch.where(zero, torch.zeros_like(x), torch.stack(out))


def inclusive_prefix_product(x: torch.Tensor) -> torch.Tensor:
    """z[j] = x[0] * ... * x[j] over the last axis, by log-step
    doubling."""
    inc = x
    d = 1
    while d < x.shape[-1]:
        inc = torch.cat([inc[..., :d], gf.mul(inc[..., d:], inc[..., :-d])],
                        dim=-1)
        d *= 2
    return inc


def exclusive_prefix_product(x: torch.Tensor) -> torch.Tensor:
    """z[0] = 1, z[j] = x[0] * ... * x[j-1] over the last axis."""
    inc = inclusive_prefix_product(x)
    return torch.cat([torch.ones_like(x[..., :1]), inc[..., :-1]], dim=-1)


def partial_products(wires: torch.Tensor, sigmas: torch.Tensor,
                     k_sub: torch.Tensor, betas, gammas, qdf: int,
                     num_prods: int) -> torch.Tensor:
    """wires, sigmas, k_sub: (nr, degree) -> (nch * (1 + num_prods),
    degree): the nch Z rows, then each challenge's num_prods partial
    products.  All challenges go through each op together."""
    nr, degree = wires.shape
    nch = len(betas)
    nchunks = -(-nr // qdf)
    pad = nchunks * qdf - nr
    scalars = lambda xs: torch.tensor(  # noqa: E731
        [gf.as_i64(int(x) % gl.P) for x in xs], dtype=torch.int64,
        device=wires.device)[:, None, None]
    b, g = scalars(betas), scalars(gammas)
    numer = gf.add(gf.add(wires[None], gf.mul(k_sub[None], b)), g)
    denom = gf.add(gf.add(wires[None], gf.mul(sigmas[None], b)), g)
    if pad:
        ones = torch.ones((nch, pad, degree), dtype=torch.int64,
                          device=wires.device)
        numer = torch.cat([numer, ones], dim=1)
        denom = torch.cat([denom, ones], dim=1)
    # (qdf, nch, nchunks, degree): the chunk's wires lead
    numer = numer.reshape(nch, nchunks, qdf, degree).permute(2, 0, 1, 3)
    denom = denom.reshape(nch, nchunks, qdf, degree).permute(2, 0, 1, 3)
    inv_den = inverse_rows(_prod_rows(denom).transpose(0, 1)).transpose(0, 1)
    chunk = gf.mul(_prod_rows(numer), inv_den)     # (nch, nchunks, degree)
    cum = [chunk[:, 0]]                           # inclusive, across chunks
    for c in range(1, nchunks):
        cum.append(gf.mul(cum[-1], chunk[:, c]))
    z = exclusive_prefix_product(cum[-1])          # (nch, degree)
    pps = gf.mul(torch.stack(cum[:num_prods], dim=1), z[:, None])
    return torch.cat([z, pps.reshape(nch * num_prods, degree)])


def device_partial_products(wires: torch.Tensor, sigmas: torch.Tensor,
                            betas, gammas, shape) -> torch.Tensor:
    """wires: the full (num_wires, degree) witness; sigmas: (nr, degree)
    routed-wire sigma values on the same device; shape: a
    plonk.circuit_shape.CircuitShape.  Runs where ``wires`` lies."""
    nr = shape.num_routed_wires
    k_sub = k_times_subgroup(tuple(shape.k_is), shape.degree_bits,
                             str(wires.device))
    return partial_products(wires[:nr], sigmas, k_sub,
                            betas, gammas, shape.quotient_degree_factor,
                            shape.num_partial_products)
