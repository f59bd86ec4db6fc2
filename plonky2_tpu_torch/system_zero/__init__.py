"""The part of plonky2_tpu/system_zero/ that the EVM tables use."""
