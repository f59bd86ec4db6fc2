"""System Zero (the port's copy of plonky2_tpu/system_zero/): the STARK of
system_zero/system_zero.py and its units; evm/memory.py takes its lookup's
permuted columns."""
