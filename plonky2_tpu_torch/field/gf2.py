"""The quadratic extension F_p[X]/(X^2 - 7) on device tensors.

The port's counterpart of plonky2_tpu/field/gf2_jax.py.  An extension batch
is a pair (c0, c1) of int64 tensors of one shape, the canonical u64 bits of
c0 + c1 X, as in field/gf.py.  The FRI composition, the fold layers and the
openings run on these.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gf
from .convert import from_u64

W = 7


def const2(c, like: torch.Tensor):
    """The host extension scalar c = (c0, c1) as a pair of 0-d tensors on
    `like`'s device."""
    return tuple(torch.tensor(gf.as_i64(int(x)), dtype=torch.int64,
                              device=like.device) for x in c)


def from_host(values, device):
    """Host extension elements [(a0, a1), ...] -> a pair of (k,) tensors."""
    a = np.asarray(values, dtype=np.uint64).reshape(-1, 2)
    return from_u64(a[:, 0], device), from_u64(a[:, 1], device)


def add2(a, b):
    return gf.add(a[0], b[0]), gf.add(a[1], b[1])


def sub2(a, b):
    return gf.sub(a[0], b[0]), gf.sub(a[1], b[1])


def mul2(a, b):
    """(a0 + a1 X)(b0 + b1 X) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) X."""
    c0 = gf.add(gf.mul(a[0], b[0]), gf.mul(gf.mul(a[1], b[1]), W))
    c1 = gf.add(gf.mul(a[0], b[1]), gf.mul(a[1], b[0]))
    return c0, c1


def mul2_base(a, s):
    """Extension times base field."""
    return gf.mul(a[0], s), gf.mul(a[1], s)


def norm2(a):
    """a0^2 - 7 a1^2, the base-field norm: 1 / a = (a0 - a1 X) / norm."""
    return gf.sub(gf.mul(a[0], a[0]), gf.mul(gf.mul(a[1], a[1]), W))


def inverse2(a, norm_inverse=None):
    """1 / a; inverse2(0) == 0.  ``norm_inverse`` is 1 / norm2(a) when the
    caller has it (a batch inversion gives the same values); otherwise one
    Fermat inverse per element."""
    inv = gf.inverse(norm2(a)) if norm_inverse is None else norm_inverse
    return gf.mul(a[0], inv), gf.mul(gf.neg(a[1]), inv)


def sum2(a, dim: int = -1):
    """Modular sum along `dim`."""
    return gf.modsum(a[0], dim), gf.modsum(a[1], dim)
