"""The Poseidon hasher configuration (the port's copy of
plonky2_tpu/hash/hashers.py:PoseidonConfig; reference
plonky2/src/plonk/config.rs:97-126): the sponges the circuit digest and
the transcript use, on hash/poseidon.py."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import poseidon as pos


class PoseidonConfig:
    name = "PoseidonGoldilocksConfig"

    @staticmethod
    def permute(state: Sequence[int]) -> List[int]:
        return pos.permute_ints(list(state))

    @staticmethod
    def hash_no_pad_elements(inputs) -> np.ndarray:
        return pos.hash_no_pad(np.asarray(inputs, dtype=np.uint64))

    @staticmethod
    def hash_pad_elements(inputs: List[int]) -> np.ndarray:
        """The sponge over inputs || 1 || 0...0 || 1, padded to a multiple
        of 12."""
        padded = list(inputs) + [1]
        while (len(padded) + 1) % 12 != 0:
            padded.append(0)
        padded.append(1)
        return pos.hash_no_pad(np.array(padded, dtype=np.uint64))


POSEIDON_CONFIG = PoseidonConfig()
