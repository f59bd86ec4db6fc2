"""Named stages of a proof, for a caller that times them.

The port's counterpart of plonky2_tpu/utils/timing.py:NoopTimingTree: the
prover wraps each stage in ``timing.scope(name)``; the default records
nothing.  A caller that wants stage times passes an object with its own
``scope`` (chip_smoke.py times each stage with CUDA events).
"""
from __future__ import annotations

import contextlib


class NoopTiming:
    def scope(self, name: str):
        return contextlib.nullcontext()


class Prefixed:
    """A timing whose stage names carry a prefix (one table of a
    multi-table proof)."""

    def __init__(self, timing, prefix: str):
        self.timing = timing
        self.prefix = prefix

    def scope(self, name: str):
        return self.timing.scope(self.prefix + name)
