"""The STARK permutation argument: the port's counterpart of
plonky2_tpu/stark/permutation.py (reference starky/src/permutation.rs).

``compute_permutation_z_polys`` runs as torch ops where the trace lies:
each batch's quotient (the batches' denominators inverted together, one
Fermat inverse a column of ``INVERSE_ROWS`` rows), then its exclusive
running product by log-step doubling.  ``eval_permutation_checks`` takes
its challenges as algebra values (``challenge_values``), so that the
quotient's constraint program reads them as scalar inputs and one program
serves every proof; on the verifier's scalars it gives the JAX package's
values."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..field import gf
from ..field import goldilocks as gl
from ..ops.partial_products import exclusive_prefix_product, inverse_rows

INVERSE_ROWS = 8


@dataclass(frozen=True)
class PermutationChallenge:
    beta: object
    gamma: object


@dataclass
class PermutationChallengeSet:
    challenges: List[PermutationChallenge]


def get_n_permutation_challenge_sets(challenger, num_challenges: int,
                                     num_sets: int
                                     ) -> List[PermutationChallengeSet]:
    out = []
    for _ in range(num_sets):
        chs = []
        for _ in range(num_challenges):
            beta = challenger.get_challenge()
            gamma = challenger.get_challenge()
            chs.append(PermutationChallenge(beta, gamma))
        out.append(PermutationChallengeSet(chs))
    return out


def challenge_values(alg, challenge_sets) -> List[PermutationChallengeSet]:
    """The sets with each int challenge as the algebra's constant."""
    return [PermutationChallengeSet([
        PermutationChallenge(alg.const(ch.beta), alg.const(ch.gamma))
        for ch in s.challenges]) for s in challenge_sets]


def get_permutation_batches(permutation_pairs, challenge_sets,
                            num_challenges: int, batch_size: int):
    """Batches of (pair, challenge) instances; instance i within a batch
    uses challenge_sets[i] (reference permutation.rs:207-230)."""
    instances = [(pair, chal) for pair in permutation_pairs
                 for chal in range(num_challenges)]
    batches = []
    for start in range(0, len(instances), batch_size):
        chunk = instances[start:start + batch_size]
        batches.append([
            (pair, challenge_sets[i].challenges[chal])
            for i, (pair, chal) in enumerate(chunk)])
    return batches


def _full(like: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full_like(like, gf.as_i64(value % gl.P))


def compute_permutation_z_polys(stark, config, trace: torch.Tensor,
                                challenge_sets) -> torch.Tensor:
    """trace: (COLUMNS, degree) int64 values. Returns the (num_batches,
    degree) Z values, where the trace lies."""
    batches = get_permutation_batches(stark.permutation_pairs(),
                                      challenge_sets, config.num_challenges,
                                      stark.permutation_batch_size())
    one = torch.ones_like(trace[0])
    numerators, denominators = [], []
    for instances in batches:
        numerator, denominator = one, one
        for pair, ch in instances:
            lhs = rhs = _full(one, ch.gamma)
            weight = 1
            for li, ri in pair.column_pairs:
                w = _full(one, weight)
                lhs = gf.add(lhs, gf.mul(trace[li], w))
                rhs = gf.add(rhs, gf.mul(trace[ri], w))
                weight = weight * ch.beta % gl.P
            numerator = gf.mul(numerator, lhs)
            denominator = gf.mul(denominator, rhs)
        numerators.append(numerator)
        denominators.append(denominator)
    # every batch's denominators inverted together (inverse(0) == 0)
    dens = torch.stack(denominators)
    rows = min(INVERSE_ROWS, dens.numel())
    inv = inverse_rows(dens.reshape(rows, -1)).reshape(dens.shape)
    return exclusive_prefix_product(gf.mul(torch.stack(numerators), inv))


def eval_permutation_checks(alg, stark, config, vars, local_zs, next_zs,
                            challenge_sets, consumer) -> None:
    """(reference permutation.rs:263-320); ``challenge_sets`` hold algebra
    values."""
    one = alg.one()
    for z in local_zs:
        consumer.constraint_first_row(alg.sub(z, one))
    batches = get_permutation_batches(stark.permutation_pairs(),
                                      challenge_sets, config.num_challenges,
                                      stark.permutation_batch_size())
    for i, instances in enumerate(batches):
        lhs_prod = None
        rhs_prod = None
        for pair, ch in instances:
            lhs = rhs = ch.gamma
            weight = one
            for li, ri in pair.column_pairs:
                lhs = alg.add(lhs, alg.mul(vars.local_values[li], weight))
                rhs = alg.add(rhs, alg.mul(vars.local_values[ri], weight))
                weight = alg.mul(weight, ch.beta)
            lhs_prod = lhs if lhs_prod is None else alg.mul(lhs_prod, lhs)
            rhs_prod = rhs if rhs_prod is None else alg.mul(rhs_prod, rhs)
        consumer.constraint(alg.sub(alg.mul(next_zs[i], rhs_prod),
                                    alg.mul(local_zs[i], lhs_prod)))
