"""The Fiat-Shamir challenger: a duplex Poseidon sponge on the host.

The port's counterpart of plonky2_tpu/iop/challenger.py:Challenger, with the
same transcript: overwrite-mode absorption of rate-8 blocks, a duplexing
whenever the input buffer fills or a challenge is drawn with inputs
pending, challenges popped from the END of the output buffer, and every
observation clearing the buffered outputs.  Values are canonical python ints
(numpy uint64 accepted).  The permutation is hash/poseidon.py:permute_ints
unless another is given: the Keccak configuration passes its hash-onion
permutation (hash/hashers.py:KeccakConfig.permute).

``RecursiveChallenger`` is the same transcript in a circuit, over targets
(JAX iop/challenger.py:RecursiveChallenger), each permutation a Poseidon
gate.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..hash import poseidon as pos


class Challenger:
    def __init__(self, permutation=None):
        """permutation: [12 ints] -> [12 ints], Poseidon unless given
        (reference Challenger<F, C::Hasher>)."""
        self.sponge_state = [0] * pos.WIDTH
        self.input_buffer: List[int] = []
        self.output_buffer: List[int] = []
        self.permutation = permutation

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
        permute = self.permutation or pos.permute_ints
        state = permute(self.duplex_input_state())
        self.input_buffer.clear()
        self.sponge_state = state
        self.output_buffer = list(state[:pos.SPONGE_RATE])


class RecursiveChallenger:
    """The duplex sponge over targets, in a circuit (reference
    challenger.rs:164-299).  Its input buffer may grow beyond the rate: it
    is absorbed in overwrite chunks of the rate when a challenge is drawn,
    which is the host Challenger's transcript."""

    def __init__(self, builder):
        zero = builder.zero()
        self.sponge_state = [zero] * pos.WIDTH
        self.input_buffer: list = []
        self.output_buffer: list = []

    @classmethod
    def from_state(cls, builder, state_targets):
        """Resume a transcript in the circuit from a compacted sponge state
        (reference challenger.rs from_state, as the EVM tables' wrappers
        use it)."""
        if len(state_targets) != pos.WIDTH:
            raise ValueError(f"a sponge state has {pos.WIDTH} targets")
        ch = cls(builder)
        ch.sponge_state = list(state_targets)
        return ch

    def compact(self, builder):
        """Absorb the pending inputs and return the sponge state's
        targets: the host Challenger.compact's point of the transcript."""
        self._absorb_buffered(builder)
        self.output_buffer.clear()
        return list(self.sponge_state)

    def observe_element(self, target) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(target)

    def observe_elements(self, targets) -> None:
        for t in targets:
            self.observe_element(t)

    def observe_hash(self, hash4) -> None:
        self.observe_elements(hash4)

    def observe_cap(self, cap) -> None:
        for h in cap:
            self.observe_hash(h)

    def observe_extension_element(self, element) -> None:
        self.observe_elements(element)

    def observe_extension_elements(self, elements) -> None:
        for e in elements:
            self.observe_extension_element(e)

    def observe_openings(self, openings) -> None:
        """openings: a fri.recursive_verifier.FriOpeningsTarget."""
        for batch in openings.batches:
            self.observe_extension_elements(batch.values)

    def get_challenge(self, builder):
        self._absorb_buffered(builder)
        if not self.output_buffer:
            self.sponge_state = builder.permute(self.sponge_state)
            self.output_buffer = list(self.sponge_state[:pos.SPONGE_RATE])
        return self.output_buffer.pop()

    def get_n_challenges(self, builder, n: int) -> list:
        return [self.get_challenge(builder) for _ in range(n)]

    def get_extension_challenge(self, builder) -> tuple:
        return tuple(self.get_n_challenges(builder, 2))

    def _absorb_buffered(self, builder) -> None:
        if not self.input_buffer:
            return
        for start in range(0, len(self.input_buffer), pos.SPONGE_RATE):
            chunk = self.input_buffer[start:start + pos.SPONGE_RATE]
            self.sponge_state[:len(chunk)] = chunk
            self.sponge_state = builder.permute(self.sponge_state)
        self.output_buffer = list(self.sponge_state[:pos.SPONGE_RATE])
        self.input_buffer.clear()

    def fri_challenges(self, builder, commit_phase_merkle_caps, final_poly,
                       pow_witness, inner_fri_config):
        """The FRI challenges as a FriChallengesTarget (reference
        fri/challenges.rs:76-112)."""
        from ..fri.recursive_verifier import FriChallengesTarget
        fri_alpha = self.get_extension_challenge(builder)
        fri_betas = []
        for cap in commit_phase_merkle_caps:
            self.observe_cap(cap)
            fri_betas.append(self.get_extension_challenge(builder))
        self.observe_extension_elements(final_poly.coeffs)
        self.observe_element(pow_witness)
        fri_pow_response = self.get_challenge(builder)
        fri_query_indices = self.get_n_challenges(
            builder, inner_fri_config.num_query_rounds)
        return FriChallengesTarget(
            fri_alpha=fri_alpha, fri_betas=fri_betas,
            fri_pow_response=fri_pow_response,
            fri_query_indices=fri_query_indices)
