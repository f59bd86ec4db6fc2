"""PolynomialBatch — the batched polynomial commitment, device half.

The port's counterpart of the device path of
plonky2_tpu/fri/oracle.py:PolynomialBatch (``from_values``, ``from_coeffs``,
``_assemble_device`` and the ``polynomials``/``leaves`` host views).
Coefficients, the leaf matrix and the digest levels stay on the device; the
host views are made on first use.  Leaves are LDE rows in bit-reversed
order, one column per polynomial (+ 4 salt columns when blinding).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..field.convert import from_u64, to_u64
from ..hash.merkle import DeviceMerkleTree
from ..ops.commit import commit_from_coeffs, commit_from_values, device_salt
from ..utils.bits import log2_strict


def _on_device(x, device) -> torch.Tensor:
    """numpy uint64 array or int64 tensor -> int64 tensor on `device`
    (default cuda, wherever the argument lies)."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.int64:
            raise TypeError(f"expected int64 field elements, got {x.dtype}")
        return x.to(resolve_device(device))
    return from_u64(np.asarray(x, dtype=np.uint64), resolve_device(device))


class PolynomialBatch:
    def __init__(self, coeffs_dev: torch.Tensor, leaves_dev: torch.Tensor,
                 merkle_tree: DeviceMerkleTree, degree_log: int,
                 rate_bits: int, blinding: bool):
        self.coeffs_dev = coeffs_dev          # (B, degree)
        self.leaves_dev = leaves_dev          # (B[+salt], lde_size)
        self.merkle_tree = merkle_tree
        self.degree_log = degree_log
        self.rate_bits = rate_bits
        self.blinding = blinding
        self._polynomials: Optional[np.ndarray] = None
        self._leaves_host: Optional[np.ndarray] = None

    @property
    def polynomials(self) -> np.ndarray:
        """(B, degree) uint64 coefficients on the host."""
        if self._polynomials is None:
            self._polynomials = to_u64(self.coeffs_dev)
        return self._polynomials

    @property
    def leaves(self) -> np.ndarray:
        """(lde_size, B[+salt]) uint64 leaf rows on the host."""
        if self._leaves_host is None:
            self._leaves_host = to_u64(self.leaves_dev).T.copy()
        return self._leaves_host

    @staticmethod
    def from_values(values, rate_bits: int, blinding: bool, cap_height: int,
                    salt_rng: Optional[np.random.Generator] = None,
                    device=None) -> "PolynomialBatch":
        """Commit to the polynomials with these evaluations (B, n) on the
        2^k-th roots of unity.  Runs on `device` (default cuda, also for
        a CPU tensor: only device="cpu" runs the plain versions)."""
        values = _on_device(values, device)
        degree = values.shape[-1]
        salt = device_salt(degree << rate_bits, values.device,
                           salt_rng=salt_rng) if blinding else None
        c, leaves, levels = commit_from_values(values, rate_bits, cap_height,
                                               salt)
        return PolynomialBatch._assemble_device(c, leaves, levels, degree,
                                                rate_bits, blinding,
                                                cap_height)

    @staticmethod
    def from_coeffs(polynomials, rate_bits: int, blinding: bool,
                    cap_height: int,
                    salt_rng: Optional[np.random.Generator] = None,
                    device=None) -> "PolynomialBatch":
        coeffs = _on_device(polynomials, device)
        degree = coeffs.shape[-1]
        salt = device_salt(degree << rate_bits, coeffs.device,
                           salt_rng=salt_rng) if blinding else None
        leaves, levels = commit_from_coeffs(coeffs, rate_bits, cap_height,
                                            salt)
        return PolynomialBatch._assemble_device(coeffs, leaves, levels,
                                                degree, rate_bits, blinding,
                                                cap_height)

    @staticmethod
    def _assemble_device(coeffs_dev, leaves_dev, levels_dev, degree: int,
                         rate_bits: int, blinding: bool,
                         cap_height: int) -> "PolynomialBatch":
        tree = DeviceMerkleTree(leaves_dev, levels_dev, cap_height)
        return PolynomialBatch(coeffs_dev, leaves_dev, tree,
                               log2_strict(degree), rate_bits, blinding)
