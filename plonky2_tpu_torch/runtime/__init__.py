"""The prover session: per-circuit state reused by every proof."""
