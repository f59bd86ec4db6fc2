"""The prover's side of the FRI transcript (the port's counterpart of
plonky2_tpu/fri/challenges.py:observe_openings)."""
from __future__ import annotations

from .structure import FriOpenings


def observe_openings(challenger, openings: FriOpenings) -> None:
    """Every claimed value, batch by batch, as extension elements."""
    for batch in openings.batches:
        for v in batch.values:
            challenger.observe_extension_element(v)
