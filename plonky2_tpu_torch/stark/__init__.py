"""The STARK prover and verifier: the port's counterpart of
plonky2_tpu/stark/ (reference starky/src/)."""
