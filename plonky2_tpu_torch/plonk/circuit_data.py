"""Circuit data containers (the port's copy of
plonky2_tpu/plonk/circuit_data.py; reference
plonky2/src/plonk/circuit_data.rs), with the same attribute names, so that
plonk/prover_data.py:ProverData.from_circuit and
plonk/circuit_shape.py:CircuitShape.from_common read them as they read
the JAX package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..fri.config import FriParams
from ..fri.structure import FriInstanceInfo, FriOracleInfo
from ..gates.gate import Gate, SelectorsInfo
from ..hash.hashers import POSEIDON_CONFIG, hasher_by_name
from .config import CircuitConfig
from .prover_data import ORACLE_BLINDING, fri_instance
from .verifier import verify


@dataclass
class CommonCircuitData:
    config: CircuitConfig
    fri_params: FriParams
    gates: List[Gate]
    selectors_info: SelectorsInfo
    quotient_degree_factor: int
    num_gate_constraints: int
    num_constants: int
    num_public_inputs: int
    k_is: List[int]
    num_partial_products: int
    hasher_name: str = POSEIDON_CONFIG.name

    def hasher(self):
        """The hasher configuration (hash/hashers.py) ``hasher_name``
        names."""
        return hasher_by_name(self.hasher_name)

    def degree_bits(self) -> int:
        return self.fri_params.degree_bits

    def degree(self) -> int:
        return 1 << self.degree_bits()

    def sigmas_range(self) -> range:
        return range(self.num_constants,
                     self.num_constants + self.config.num_routed_wires)

    def zs_range(self) -> range:
        return range(0, self.config.num_challenges)

    def partial_products_range(self) -> range:
        return range(self.config.num_challenges,
                     self.num_zs_partial_products_polys())

    def num_preprocessed_polys(self) -> int:
        return self.sigmas_range().stop

    def num_zs_partial_products_polys(self) -> int:
        return self.config.num_challenges * (1 + self.num_partial_products)

    def num_quotient_polys(self) -> int:
        return self.config.num_challenges * self.quotient_degree_factor

    def fri_oracles(self) -> List[FriOracleInfo]:
        """The four oracles: constants-sigmas, wires, Z/PP, quotient."""
        return [FriOracleInfo(n, b) for n, b in zip(
            (self.num_preprocessed_polys(), self.config.num_wires,
             self.num_zs_partial_products_polys(),
             self.num_quotient_polys()), ORACLE_BLINDING)]

    def get_fri_instance(self, zeta) -> FriInstanceInfo:
        return fri_instance((self.num_preprocessed_polys(),
                             self.config.num_wires,
                             self.num_zs_partial_products_polys(),
                             self.num_quotient_polys()),
                            self.degree_bits(), self.config.num_challenges,
                            zeta)


@dataclass
class ProverOnlyCircuitData:
    generators: list
    generator_indices_by_watches: Dict[int, List[int]]
    constants_sigmas_commitment: object  # fri.oracle.PolynomialBatch
    sigmas: np.ndarray          # (degree, num_routed_wires) sigma values
    subgroup: np.ndarray        # (degree,)
    public_inputs: list
    representative_map: np.ndarray
    circuit_digest: np.ndarray  # (4,)


@dataclass
class VerifierOnlyCircuitData:
    constants_sigmas_cap: object  # hash.merkle.MerkleCap
    circuit_digest: np.ndarray


@dataclass
class CircuitData:
    prover_only: ProverOnlyCircuitData
    verifier_only: VerifierOnlyCircuitData
    common: CommonCircuitData

    def verify(self, proof_with_pis) -> None:
        """Raises if the proof does not verify (plonk/verifier.py)."""
        verify(proof_with_pis, self.verifier_only, self.common)
