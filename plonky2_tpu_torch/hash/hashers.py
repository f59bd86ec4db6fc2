"""The hasher configurations (the port's copy of
plonky2_tpu/hash/hashers.py; reference plonky2/src/plonk/config.rs:97-126):
the hashes of a circuit's Merkle trees, its digest and its transcript.

``PoseidonConfig`` is algebraic: its trees are hashed on the device
(kernels K1 and K2, hash/merkle_torch.py) and its transcript may run
there too.  ``KeccakConfig`` is not: 25-byte Keccak digests, hashed on the
host (hash/keccak.py), carried in the same 4-element containers through
the lossless 7-byte-chunk encoding (BytesHash::to_vec, hash_types.rs:179),
so caps, the challenger's observations and serialization do not depend on
the hasher.  Both give ``hash_or_noop_ints``, ``compress_ints`` and
``permute`` on python ints; ``KeccakConfig`` also gives ``hash_leaves``
and ``compress_batch`` for many leaves and pairs at once (numpy), which
the host-hashed tree (hash/merkle.py:MerkleTree) uses.  A Poseidon tree
is only ever hashed on the device.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import keccak as kc
from . import poseidon as pos


def _keccak_digest_to_elems(digest: bytes) -> List[int]:
    return kc.KeccakHasher.hash_to_elements(digest)


def _elems_to_keccak_digest(elems: Sequence[int]) -> bytes:
    out = b"".join(int(e).to_bytes(7, "little") for e in elems[:3])
    return out + int(elems[3]).to_bytes(4, "little")


class _HasherConfig:
    name: str
    algebraic: bool

    @classmethod
    def hash_pad_elements(cls, inputs: List[int]) -> np.ndarray:
        """The hash of inputs || 1 || 0...0 || 1, padded to a multiple of
        12."""
        padded = list(inputs) + [1]
        while (len(padded) + 1) % 12 != 0:
            padded.append(0)
        padded.append(1)
        return cls.hash_no_pad_elements(np.array(padded, dtype=np.uint64))


class PoseidonConfig(_HasherConfig):
    name = "PoseidonGoldilocksConfig"
    algebraic = True

    @staticmethod
    def hash_or_noop_ints(leaf) -> List[int]:
        return pos.hash_or_noop_ints(np.asarray(leaf, dtype=np.uint64))

    @staticmethod
    def compress_ints(left, right) -> List[int]:
        return pos.compress_ints(left, right)

    @staticmethod
    def permute(state: Sequence[int]) -> List[int]:
        return pos.permute_ints(list(state))

    @staticmethod
    def hash_no_pad_elements(inputs) -> np.ndarray:
        return pos.hash_no_pad(np.asarray(inputs, dtype=np.uint64))


class KeccakConfig(_HasherConfig):
    name = "KeccakGoldilocksConfig"
    algebraic = False

    @staticmethod
    def hash_leaves(leaves: np.ndarray) -> np.ndarray:
        return kc.hash_or_noop_batch(leaves)

    @staticmethod
    def compress_batch(left: np.ndarray, right: np.ndarray) -> np.ndarray:
        return kc.two_to_one_batch(left, right)

    @staticmethod
    def hash_or_noop_ints(leaf) -> List[int]:
        return _keccak_digest_to_elems(kc.KeccakHasher.hash_or_noop(
            [int(x) for x in np.asarray(leaf, dtype=np.uint64).reshape(-1)]))

    @staticmethod
    def compress_ints(left, right) -> List[int]:
        return _keccak_digest_to_elems(kc.KeccakHasher.two_to_one(
            _elems_to_keccak_digest(left), _elems_to_keccak_digest(right)))

    @staticmethod
    def permute(state: Sequence[int]) -> List[int]:
        return kc.KeccakHasher.permute(state)

    @staticmethod
    def hash_no_pad_elements(inputs) -> np.ndarray:
        digest = kc.KeccakHasher.hash_no_pad(
            [int(x) for x in np.asarray(inputs, dtype=np.uint64).reshape(-1)])
        return np.array(_keccak_digest_to_elems(digest), dtype=np.uint64)


POSEIDON_CONFIG = PoseidonConfig()
KECCAK_CONFIG = KeccakConfig()


def hasher_by_name(name: str):
    """The configuration a CommonCircuitData's ``hasher_name`` names."""
    for config in (POSEIDON_CONFIG, KECCAK_CONFIG):
        if config.name == name:
            return config
    raise ValueError(f"unknown hasher configuration {name!r}")
