"""Merkle path compression: the path nodes that several proofs on one tree
share are kept once (the port's copy of
plonky2_tpu/hash/path_compression.py; reference
plonky2/src/hash/path_compression.rs).  The hasher's digests (Poseidon's
unless given), on the host."""
from __future__ import annotations

from typing import List

import numpy as np

from .hashers import POSEIDON_CONFIG
from .merkle import MerkleProof


def compress_merkle_proofs(cap_height: int, indices: List[int],
                           proofs: List[MerkleProof]) -> List[MerkleProof]:
    if not proofs:
        raise ValueError("no proofs to compress")
    height = cap_height + len(proofs[0].siblings)
    num_leaves = 1 << height
    known = [False] * (2 * num_leaves)
    for i in indices:
        for j in range(height - cap_height):
            known[(i + num_leaves) >> j] = True

    compressed = []
    for i, p in zip(indices, proofs):
        siblings = []
        index = i + num_leaves
        for sibling in p.siblings:
            sibling_index = index ^ 1
            if not known[sibling_index]:
                siblings.append(sibling)
                known[sibling_index] = True
            index >>= 1
            known[index] = True
        compressed.append(MerkleProof(siblings))
    return compressed


def decompress_merkle_proofs(leaves_data: List, leaves_indices: List[int],
                             compressed_proofs: List[MerkleProof],
                             height: int, cap_height: int,
                             hasher=POSEIDON_CONFIG) -> List[MerkleProof]:
    """The inverse of compress_merkle_proofs; the leaves and indices come
    in the order they were compressed in, and the digests are the
    hasher's."""
    num_leaves = 1 << height
    seen = {}
    for i, v in zip(leaves_indices, leaves_data):
        seen[i + num_leaves] = hasher.hash_or_noop_ints(
            np.asarray(v, dtype=np.uint64).reshape(-1))

    sibling_iters = [iter(p.siblings) for p in compressed_proofs]
    for layer_height in range(height - cap_height):
        for i, sib_iter in zip(leaves_indices, sibling_iters):
            index = (i + num_leaves) >> layer_height
            current = seen[index]
            sibling_index = index ^ 1
            if sibling_index not in seen:
                seen[sibling_index] = [
                    int(x) for x in np.asarray(next(sib_iter)).reshape(4)]
            sibling = seen[sibling_index]
            if index % 2 == 0:
                parent = hasher.compress_ints(current, sibling)
            else:
                parent = hasher.compress_ints(sibling, current)
            seen[index >> 1] = parent

    out = []
    for i in leaves_indices:
        siblings = []
        index = i + num_leaves
        for _ in range(height - cap_height):
            siblings.append(np.array(seen[index ^ 1], dtype=np.uint64))
            index >>= 1
        out.append(MerkleProof(siblings))
    return out
