"""FRI proof of work and query rounds.

The port's counterpart of plonky2_tpu/fri/prover.py:fri_proof_of_work (the
Poseidon branch) and ``fri_prover_query_rounds``.  ``fri_proof_of_work`` is
the layered FRI's grind, from the host challenger's state: it runs where
the proof's tensors lie, on a CUDA device as one launch of kernel K8
(hash/poseidon_cuda.py:pow_grind_cuda) and on the CPU as K8's plain
version.  The fused FRI grinds on the card's transcript instead
(iop/challenger_torch.py:DeviceChallenger.grind).  Either finds
the smallest witness whose response has ``proof_of_work_bits`` leading
zeros, as the JAX package's host grind does, so both packages find the
same one.  The query rounds read rows and sibling paths from
device-resident trees (hash/merkle.py:DeviceMerkleTree), which the caller
prefetches in one gather per tree.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..field.convert import from_u64
from ..hash import poseidon as pos
from ..hash import poseidon_cuda as pc
from ..hash.hashers import POSEIDON_CONFIG
from .proof import FriInitialTreeProof, FriQueryRound, FriQueryStep


def fri_proof_of_work(challenger, config, device,
                      hasher=POSEIDON_CONFIG) -> int:
    """Grind on `device` (the challenger's duplex state goes up, the
    witness comes down), or on the host for a non-algebraic hasher;
    observe the witness, draw the response and check it."""
    bits = config.proof_of_work_bits
    if hasher.algebraic:
        base = from_u64(np.array(challenger.duplex_input_state(),
                                 dtype=np.uint64), device)
        witness = pc.pow_grind_cuda(base, len(challenger.input_buffer), bits)
    else:
        witness = host_pow_grind(challenger, bits, hasher)
    challenger.observe_element(witness)
    if challenger.get_challenge() >= 1 << (64 - bits):
        raise RuntimeError("proof-of-work response above its bound")
    return witness


def host_pow_grind(challenger, bits: int, hasher) -> int:
    """The smallest witness whose duplexing, through the hasher's
    permutation, leaves a response below 2^(64 - bits)."""
    bound = 1 << (64 - bits)
    state = challenger.duplex_input_state()
    slot = len(challenger.input_buffer)
    witness = 0
    while True:
        state[slot] = witness
        if hasher.permute(state)[pos.SPONGE_RATE - 1] < bound:
            return witness
        witness += 1


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
