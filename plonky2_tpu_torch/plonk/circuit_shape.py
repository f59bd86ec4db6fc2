"""The circuit dimensions that the quotient round reads.

The port's counterpart of the parts of
plonky2_tpu/plonk/circuit_data.py:CommonCircuitData that the prover's
phases 3-6 (partial products, Z/PP commitment, quotient, quotient
commitment) read.  ``from_common`` copies them from a JAX
``CommonCircuitData`` by attribute name, without importing it; ``arrays``/
``from_arrays`` store them beside the compiled program in one ``.npz``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

_INTS = ("degree_bits", "rate_bits", "cap_height", "quotient_degree_factor",
         "num_challenges", "num_wires", "num_routed_wires",
         "num_preprocessed_polys", "num_partial_products", "num_zs_pp",
         "zero_knowledge")


@dataclass(frozen=True)
class CircuitShape:
    degree_bits: int
    rate_bits: int
    cap_height: int
    quotient_degree_factor: int
    num_challenges: int
    num_wires: int
    num_routed_wires: int
    num_preprocessed_polys: int   # constants + sigmas (the cs oracle)
    num_partial_products: int     # per challenge
    num_zs_pp: int                # Z/PP range stop: nch * (1 + num_pp)
    zero_knowledge: bool
    k_is: Tuple[int, ...]         # coset representatives of the sigmas

    @property
    def degree(self) -> int:
        return 1 << self.degree_bits

    @property
    def quotient_degree_bits(self) -> int:
        q = self.quotient_degree_factor
        return (q - 1).bit_length() if q > 1 else 0

    @property
    def num_quotient_polys(self) -> int:
        return self.num_challenges * self.quotient_degree_factor

    @staticmethod
    def from_common(common) -> "CircuitShape":
        config = common.config
        return CircuitShape(
            degree_bits=int(common.degree_bits()),
            rate_bits=int(config.fri_config.rate_bits),
            cap_height=int(config.fri_config.cap_height),
            quotient_degree_factor=int(common.quotient_degree_factor),
            num_challenges=int(config.num_challenges),
            num_wires=int(config.num_wires),
            num_routed_wires=int(config.num_routed_wires),
            num_preprocessed_polys=int(common.num_preprocessed_polys()),
            num_partial_products=int(common.num_partial_products),
            num_zs_pp=int(common.partial_products_range().stop),
            zero_knowledge=bool(config.zero_knowledge),
            k_is=tuple(int(k) for k in common.k_is))

    def arrays(self) -> dict:
        out = {k: np.int64(getattr(self, k)) for k in _INTS}
        out["k_is"] = np.asarray(self.k_is, dtype=np.uint64)
        return out

    @staticmethod
    def from_arrays(arrays) -> "CircuitShape":
        kw = {k: int(arrays[k]) for k in _INTS}
        kw["zero_knowledge"] = bool(kw["zero_knowledge"])
        kw["k_is"] = tuple(int(k) for k in np.asarray(arrays["k_is"]))
        return CircuitShape(**kw)
