"""The Fiat-Shamir transcript (the port's counterpart of plonky2_tpu/iop)."""
