"""The multi-table STARK prover with cross-table lookups and its four
tables (keccak-f, keccak sponge, logic, memory): the port's counterpart of
the matching part of plonky2_tpu/evm/ (reference evm/src/)."""
