"""Merkle caps, proofs and the device-resident tree.

The port's counterpart of plonky2_tpu/hash/merkle.py: leaves and digest
levels stay on the device, and the cap is copied to the host when it is
first read, so building a tree never waits for the card.  ``gather`` takes
the rows and sibling paths of many queries on the device from device
indices (the JAX package's ``tree_fetch`` in its fused FRI); ``prefetch``
does the same from host indices with one copy to the host, and ``store``
keeps rows and paths that came to the host with other data.  Proofs verify
against the cap on the host with the scalar permutation (hash/poseidon.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..field.convert import to_u64
from ..utils.bits import log2_strict
from . import poseidon as pos


@dataclass
class MerkleProof:
    siblings: List[np.ndarray]  # each (4,) uint64 digest, leaf level upward


@dataclass
class MerkleCap:
    digests: np.ndarray  # (2^cap_height, 4) uint64


class DeviceMerkleTree:
    """Leaves (L, N) and levels [(4, N), ..., (4, 2^h)] resident as int64
    tensors; the host sees the cap, and rows and paths on demand."""

    def __init__(self, leaves_dev: torch.Tensor, levels_dev: list,
                 cap_height: int):
        self.leaves_dev = leaves_dev
        self.levels_dev = levels_dev
        self.cap_height = cap_height
        self._cap = None
        self._rows: dict = {}
        self._paths: dict = {}

    @property
    def cap(self) -> MerkleCap:
        """The top level's digests on the host, copied on first read."""
        if self._cap is None:
            self.keep_cap(to_u64(self.levels_dev[-1]))
        return self._cap

    def keep_cap(self, top) -> None:
        """Keep the top level (4, 2^h), already copied to the host, as the
        cap."""
        self._cap = MerkleCap(np.asarray(top, dtype=np.uint64).T.copy())

    @property
    def num_leaves(self) -> int:
        return self.leaves_dev.shape[1]

    def num_layers(self) -> int:
        return log2_strict(self.num_leaves) - self.cap_height

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows and whole sibling paths of the leaves at `idx` (an int64
        tensor on the tree's device), on the device: (Q, L + 4 * layers),
        the row, then the siblings from the leaf level up."""
        parts = [self.leaves_dev[:, idx].T]                   # (Q, L)
        cur = idx
        for layer in range(self.num_layers()):
            parts.append(self.levels_dev[layer][:, cur ^ 1].T)  # (Q, 4)
            cur = cur >> 1
        return torch.cat(parts, dim=1)

    def store(self, indices, host: np.ndarray) -> None:
        """Keep the rows and paths of ``gather(indices)``, copied to the
        host as a (Q, L + 4 * layers) uint64 array."""
        L = self.leaves_dev.shape[0]
        for k, i in enumerate(int(i) for i in indices):
            self._rows[i] = host[k, :L]
            self._paths[i] = [host[k, L + 4 * j:L + 4 * (j + 1)]
                              for j in range(self.num_layers())]

    def prefetch(self, indices) -> None:
        """Rows and whole sibling paths of many leaves in one gather."""
        todo = [i for i in dict.fromkeys(int(i) for i in indices)
                if i not in self._rows]
        if not todo:
            return
        idx = torch.tensor(todo, dtype=torch.int64,
                           device=self.leaves_dev.device)
        self.store(todo, to_u64(self.gather(idx)))

    def get(self, i: int) -> np.ndarray:
        if i not in self._rows:
            self.prefetch([i])
        return self._rows[i]

    def prove(self, leaf_index: int) -> MerkleProof:
        if leaf_index not in self._paths:
            self.prefetch([leaf_index])
        return MerkleProof([s.copy() for s in self._paths[leaf_index]])


def verify_merkle_proof_to_cap(leaf, leaf_index: int, cap: MerkleCap,
                               proof: MerkleProof) -> bool:
    """Hash the leaf, walk the siblings up, and compare with the cap entry."""
    h = pos.hash_or_noop_ints(np.asarray(leaf, dtype=np.uint64).reshape(-1))
    idx = leaf_index
    for sib in proof.siblings:
        sib = [int(x) for x in sib]
        h = pos.compress_ints(sib, h) if idx & 1 else pos.compress_ints(h, sib)
        idx >>= 1
    return [int(x) for x in cap.digests[idx]] == h
