"""Conversions between the port's storage format and the host formats.

The port stores a Goldilocks element as the canonical u64 bit pattern in a
``torch.int64`` tensor.  The JAX package uses numpy ``uint64`` arrays on the
host and ``(lo, hi)`` uint32 pairs on the device.  These functions carry state
across: the same values reach both packages bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def from_u64(x, device=None) -> torch.Tensor:
    """numpy uint64 array -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.uint64)).view(np.int64)
    t = torch.from_numpy(a.copy())
    return t if device is None else t.to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor (any device) -> numpy uint64 array with the same bits."""
    if t.dtype != torch.int64:
        raise TypeError(f"expected an int64 tensor, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def from_pair(pair, device=None) -> torch.Tensor:
    """JAX-style (lo, hi) uint32 arrays -> int64 tensor."""
    lo = np.asarray(pair[0], dtype=np.uint32).astype(np.uint64)
    hi = np.asarray(pair[1], dtype=np.uint32).astype(np.uint64)
    return from_u64(lo | (hi << np.uint64(32)), device)


def to_pair(t: torch.Tensor):
    """int64 tensor -> JAX-style (lo, hi) numpy uint32 arrays."""
    u = to_u64(t)
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))
