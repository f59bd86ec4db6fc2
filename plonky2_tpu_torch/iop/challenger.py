"""The Fiat-Shamir challenger: a duplex Poseidon sponge on the host.

The port's counterpart of plonky2_tpu/iop/challenger.py:Challenger, with the
same transcript: overwrite-mode absorption of rate-8 blocks, a duplexing
whenever the input buffer fills or a challenge is drawn with inputs
pending, challenges popped from the END of the output buffer, and every
observation clearing the buffered outputs.  Values are canonical python ints
(numpy uint64 accepted).  The permutation is hash/poseidon.py:permute_ints.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..hash import poseidon as pos


class Challenger:
    def __init__(self):
        self.sponge_state = [0] * pos.WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []

    def observe_element(self, element) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(int(element))
        if len(self.input_buffer) == pos.SPONGE_RATE:
            self._duplexing()

    def observe_elements(self, elements: Sequence) -> None:
        for e in np.asarray(elements, dtype=np.uint64).reshape(-1):
            self.observe_element(e)

    def observe_extension_element(self, element) -> None:
        """element: an (a0, a1) pair."""
        a = np.asarray(element, dtype=np.uint64).reshape(-1)
        if a.shape[0] != 2:
            raise ValueError(f"an extension element has 2 coordinates, "
                             f"got {a.shape[0]}")
        self.observe_elements(a)

    def observe_extension_elements(self, elements) -> None:
        for e in np.asarray(elements, dtype=np.uint64).reshape(-1, 2):
            self.observe_extension_element(e)

    def observe_hash(self, hash4) -> None:
        self.observe_elements(np.asarray(hash4, dtype=np.uint64).reshape(4))

    def observe_cap(self, cap) -> None:
        """cap: a MerkleCap or a (k, 4) digest array."""
        digests = cap.digests if hasattr(cap, "digests") else cap
        for d in np.asarray(digests, dtype=np.uint64).reshape(-1, 4):
            self.observe_hash(d)

    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> List[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_hash(self) -> np.ndarray:
        return np.array(self.get_n_challenges(4), dtype=np.uint64)

    def get_extension_challenge(self) -> tuple:
        c = self.get_n_challenges(2)
        return (c[0], c[1])

    def get_n_extension_challenges(self, n: int) -> List[tuple]:
        return [self.get_extension_challenge() for _ in range(n)]

    def duplex_input_state(self) -> List[int]:
        """The state the next duplexing permutes: the sponge state with the
        pending inputs written over its first words (the proof-of-work
        grind varies the word after them)."""
        state = list(self.sponge_state)
        state[:len(self.input_buffer)] = self.input_buffer
        return state

    def compact(self) -> List[int]:
        """Absorb the pending inputs and drop the buffered outputs, so the
        transcript goes on from the sponge state alone (JAX
        iop/challenger.py:84); returns that state."""
        if self.input_buffer:
            self._duplexing()
        self.output_buffer.clear()
        return list(self.sponge_state)

    def _duplexing(self) -> None:
        if len(self.input_buffer) > pos.SPONGE_RATE:
            raise RuntimeError("input buffer beyond the sponge rate")
        state = pos.permute_ints(self.duplex_input_state())
        self.input_buffer.clear()
        self.sponge_state = state
        self.output_buffer = list(state[:pos.SPONGE_RATE])
