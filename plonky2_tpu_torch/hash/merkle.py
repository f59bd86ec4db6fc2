"""Merkle caps, proofs and the device-resident tree.

The port's counterpart of plonky2_tpu/hash/merkle.py: leaves and digest
levels stay on the device, and the cap is copied to the host when it is
first read, so building a tree never waits for the card.  ``MerkleTree``
is the tree of a hasher that runs on the host (the non-algebraic Keccak
configuration, hash/hashers.py): its digests are computed on the host
from the leaves brought down once, and placed beside the leaves, which
stay where they lie, so that it answers queries as the device tree does.  ``gather`` takes
the rows and sibling paths of many queries on the device from device
indices (the JAX package's ``tree_fetch`` in its fused FRI); ``prefetch``
does the same from host indices with one copy to the host, and ``store``
keeps rows and paths that came to the host with other data.  Proofs verify
against the cap on the host with the hasher's scalar functions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..field.convert import from_u64, to_u64
from ..utils.bits import log2_strict
from . import merkle_torch
from .hashers import POSEIDON_CONFIG


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


def build_digest_levels(leaves: np.ndarray, cap_height: int,
                        hasher) -> List[np.ndarray]:
    """(N, L) leaves -> [(N, 4), (N/2, 4), ..., (2^cap_height, 4)] digests
    by a non-algebraic hasher on the host, one batch a level (JAX
    hash/merkle.py:32).  An algebraic hasher's tree is hashed on the device
    (hash/merkle_torch.py) and is refused here."""
    if hasher.algebraic:
        raise ValueError(f"{hasher.name} trees are hashed on the device "
                         "(merkle_tree), not on the host")
    bits = log2_strict(leaves.shape[0])
    if cap_height > bits:
        raise ValueError(f"cap height {cap_height} above tree height {bits}")
    levels = [hasher.hash_leaves(leaves)]
    for _ in range(bits - cap_height):
        cur = levels[-1]
        levels.append(hasher.compress_batch(cur[0::2], cur[1::2]))
    return levels


class MerkleTree(DeviceMerkleTree):
    """A tree hashed on the host by the non-algebraic `hasher` (JAX
    hash/merkle.py:62).
    ``leaves`` is an (L, N) int64 tensor, which stays on its device and is
    copied to the host once, or (N, L) uint64 rows on the host (the JAX
    package's form).  The digest levels are placed beside the leaves, so
    rows and paths are read as from a DeviceMerkleTree."""

    def __init__(self, leaves, cap_height: int, hasher):
        if isinstance(leaves, torch.Tensor):
            rows = to_u64(leaves).T
        else:
            rows = np.asarray(leaves, dtype=np.uint64)
            leaves = from_u64(rows.T.copy(), "cpu")
        levels = build_digest_levels(rows, cap_height, hasher)
        super().__init__(leaves, [from_u64(lv.T.copy(), leaves.device)
                                  for lv in levels], cap_height)
        self.keep_cap(levels[-1].T)
        self.hasher = hasher


def merkle_tree(leaves: torch.Tensor, cap_height: int,
                hasher=POSEIDON_CONFIG) -> DeviceMerkleTree:
    """The tree of (L, N) leaves on their device: hashed there by K1 and
    K2 for an algebraic hasher (hash/merkle_torch.py), else on the host
    (MerkleTree)."""
    if not hasher.algebraic:
        return MerkleTree(leaves, cap_height, hasher)
    return DeviceMerkleTree(
        leaves, merkle_torch.build_digest_levels(leaves, cap_height),
        cap_height)


def verify_merkle_proof_to_cap(leaf, leaf_index: int, cap: MerkleCap,
                               proof: MerkleProof,
                               hasher=POSEIDON_CONFIG) -> bool:
    """Hash the leaf, walk the siblings up, and compare with the cap entry."""
    h = hasher.hash_or_noop_ints(np.asarray(leaf, dtype=np.uint64).reshape(-1))
    idx = leaf_index
    for sib in proof.siblings:
        sib = [int(x) for x in sib]
        h = (hasher.compress_ints(sib, h) if idx & 1
             else hasher.compress_ints(h, sib))
        idx >>= 1
    return [int(x) for x in cap.digests[idx]] == h
