"""FRI proof of work and query rounds.

The port's counterpart of plonky2_tpu/fri/prover.py:fri_proof_of_work (the
Poseidon branch) and ``fri_prover_query_rounds``.  The grind runs on the
host, as the JAX package's layered FRI path runs it: batches of candidate
witnesses through the numpy permutation (hash/poseidon.py:poseidon), and the
smallest witness whose response has ``proof_of_work_bits`` leading zeros
wins, so both packages find the same one.  The query rounds read rows and
sibling paths from device-resident trees (hash/merkle.py:DeviceMerkleTree),
which the caller prefetches in one gather per tree.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..hash import poseidon as pos
from .proof import FriInitialTreeProof, FriQueryRound, FriQueryStep

POW_BATCH = 1 << 12
POW_LIMIT = 1 << 40


def fri_proof_of_work(challenger, config) -> int:
    """Grind, observe the witness, draw the response and check it."""
    bound = 1 << (64 - config.proof_of_work_bits)
    base = np.array(challenger.duplex_input_state(), dtype=np.uint64)
    witness_pos = len(challenger.input_buffer)
    witness = None
    start = 0
    while witness is None:
        if start >= POW_LIMIT:
            raise RuntimeError("proof-of-work search ran past 2^40")
        states = np.broadcast_to(base, (POW_BATCH, pos.WIDTH)).copy()
        states[:, witness_pos] = np.arange(start, start + POW_BATCH,
                                           dtype=np.uint64)
        responses = pos.poseidon(states)[:, pos.SPONGE_RATE - 1]
        ok = np.flatnonzero(responses < np.uint64(bound)) if bound < 1 << 64 \
            else np.arange(POW_BATCH)
        if ok.size:
            witness = start + int(ok[0])
        start += POW_BATCH
    challenger.observe_element(witness)
    if challenger.get_challenge() >= bound:
        raise RuntimeError("proof-of-work response above its bound")
    return witness


def fri_prover_query_rounds(initial_trees, trees, indices,
                            fri_params) -> List[FriQueryRound]:
    """One round per query index x: every initial tree's row x with its
    path, then each layer tree's row x >> (arity bits so far), unflattened
    to (arity, 2) extension values, with its path."""
    rounds = []
    for x_index in indices:
        initial = [(t.get(x_index).copy(), t.prove(x_index))
                   for t in initial_trees]
        steps = []
        xi = x_index
        for tree, arity_bits in zip(trees, fri_params.reduction_arity_bits):
            xi >>= arity_bits
            steps.append(FriQueryStep(evals=tree.get(xi).reshape(-1, 2),
                                      merkle_proof=tree.prove(xi)))
        rounds.append(FriQueryRound(
            initial_trees_proof=FriInitialTreeProof(evals_proofs=initial),
            steps=steps))
    return rounds
