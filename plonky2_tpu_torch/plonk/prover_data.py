"""What the prover's phases 2-8 read about a circuit.

The port's counterpart of the parts of plonky2_tpu/plonk/circuit_data.py
(``CommonCircuitData``, ``ProverOnlyCircuitData``) that ``plonk/prover.py:
prove`` reads: the circuit's dimensions (``CircuitShape``), its FRI
parameters, the compiled quotient program, the constants-sigmas
polynomials' coefficients, the sigma values, the circuit digest and where
the public inputs lie in the witness.  ``from_circuit`` copies these from a
JAX ``CircuitData``'s parts by attribute name, without importing it.

Polynomial ranges and the FRI instance follow the oracles' order: constants
| sigmas (oracle 0), wires (1), Zs | partial products (2), quotient
chunks (3).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..field import extension as ext
from ..field import goldilocks as gl
from ..fri.config import FriConfig, FriParams, FriReductionStrategy
from ..fri.structure import (FriBatchInfo, FriInstanceInfo, FriOracleInfo,
                             FriPolynomialInfo)
from ..hash.hashers import POSEIDON_CONFIG, hasher_by_name
from .circuit_shape import CircuitShape

# blinding flag per oracle: constants-sigmas, wires, Z/PP, quotient
ORACLE_BLINDING = (False, True, True, True)


@dataclass
class ProverData:
    shape: CircuitShape
    num_constants: int
    fri_params: FriParams
    program: object               # the quotient ConstraintProgram
    cs_coeffs: object             # (num_preprocessed_polys, degree) coefficients
    sigmas: object                # (num_routed_wires, degree) sigma values
    circuit_digest: Tuple[int, ...]
    public_input_wires: Tuple[Tuple[int, int], ...]   # (wire, row) each
    hasher_name: str = POSEIDON_CONFIG.name

    def hasher(self):
        """The hasher configuration of the circuit's trees and
        transcript (hash/hashers.py)."""
        return hasher_by_name(self.hasher_name)

    def constants_range(self) -> range:
        return range(0, self.num_constants)

    def sigmas_range(self) -> range:
        return range(self.num_constants,
                     self.num_constants + self.shape.num_routed_wires)

    def zs_range(self) -> range:
        return range(0, self.shape.num_challenges)

    def partial_products_range(self) -> range:
        return range(self.shape.num_challenges, self.shape.num_zs_pp)

    def get_fri_instance(self, zeta) -> FriInstanceInfo:
        s = self.shape
        return fri_instance((s.num_preprocessed_polys, s.num_wires,
                             s.num_zs_pp, s.num_quotient_polys),
                            s.degree_bits, s.num_challenges, zeta)

    def public_inputs(self, witness) -> List[int]:
        """The public inputs' values, read from the (num_wires, degree)
        witness (numpy uint64 or an int64 tensor)."""
        if not self.public_input_wires:
            return []
        w, r = (list(x) for x in zip(*self.public_input_wires))
        vals = witness[w, r]
        if hasattr(vals, "cpu"):
            vals = vals.cpu().numpy().view(np.uint64)
        return [int(v) for v in vals]

    @staticmethod
    def from_circuit(prover_only, common, program) -> "ProverData":
        """From a JAX ``ProverOnlyCircuitData`` and ``CommonCircuitData``
        (read by attribute name) and the circuit's quotient program."""
        shape = CircuitShape.from_common(common)
        cs = np.asarray(prover_only.constants_sigmas_commitment.polynomials,
                        dtype=np.uint64)
        return ProverData(
            shape=shape, num_constants=int(common.num_constants),
            fri_params=fri_params_from(common.fri_params), program=program,
            cs_coeffs=cs,
            sigmas=np.ascontiguousarray(
                np.asarray(prover_only.sigmas, dtype=np.uint64).T),
            circuit_digest=tuple(int(x) for x in prover_only.circuit_digest),
            public_input_wires=public_input_wires(
                prover_only.public_inputs, prover_only.representative_map,
                shape.num_wires, shape.degree),
            hasher_name=common.hasher_name)


def fri_instance(sizes, degree_bits: int, num_challenges: int,
                 zeta) -> FriInstanceInfo:
    """The four oracles of `sizes` polynomials (constants-sigmas, wires,
    Z/PP, quotient), every polynomial opened at zeta and the Zs also at
    g * zeta (reference circuit_data.rs:351-371)."""
    oracles = [FriOracleInfo(n, b) for n, b in zip(sizes, ORACLE_BLINDING)]
    polys = [p for o, n in enumerate(sizes)
             for p in FriPolynomialInfo.from_range(o, range(n))]
    g = gl.primitive_root_of_unity(degree_bits)
    return FriInstanceInfo(
        oracles=oracles,
        batches=[FriBatchInfo(point=tuple(zeta), polynomials=polys),
                 FriBatchInfo(point=ext.s_mul(zeta, (g, 0)),
                              polynomials=FriPolynomialInfo.from_range(
                                  2, range(num_challenges)))])


def fri_params_from(params) -> FriParams:
    """A FriParams with the same fields as `params` (any object that has
    them, such as the JAX package's)."""
    c, s = params.config, params.config.reduction_strategy
    strategy = FriReductionStrategy(
        kind=s.kind, arities=tuple(s.arities), arity_bits=s.arity_bits,
        final_poly_bits=s.final_poly_bits, max_arity_bits=s.max_arity_bits)
    config = FriConfig(rate_bits=c.rate_bits, cap_height=c.cap_height,
                       proof_of_work_bits=c.proof_of_work_bits,
                       reduction_strategy=strategy,
                       num_query_rounds=c.num_query_rounds)
    return FriParams(config=config, hiding=bool(params.hiding),
                     degree_bits=int(params.degree_bits),
                     reduction_arity_bits=tuple(params.reduction_arity_bits))


def public_input_wires(targets, representative_map, num_wires: int,
                       degree: int) -> Tuple[Tuple[int, int], ...]:
    """(wire, row) of a witness cell in each public input's copy class.

    A target is ("w", row, wire) or ("v", index); the copy-constraint
    forest's flat index of a cell is row * num_wires + wire, of a virtual
    target degree * num_wires + index (JAX iop/target.py:target_index)."""
    reps = np.asarray(representative_map, dtype=np.int64)
    cells = reps[:degree * num_wires]
    out = []
    for t in targets:
        flat = (t[1] * num_wires + t[2] if t[0] == "w"
                else degree * num_wires + t[1])
        hit = np.flatnonzero(cells == reps[flat])
        if not hit.size:
            raise ValueError(f"public input {t} is copied to no wire")
        out.append((int(hit[0] % num_wires), int(hit[0] // num_wires)))
    return tuple(out)
