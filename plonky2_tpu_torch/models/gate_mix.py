"""The gate-mix circuit: every gate of plonky2's recursion gate set.

One copy of the mix places, through the builder's gadgets, the gates that
the recursive verifier uses (models/bench_recursion.py in the JAX
package): extension multiply and multiply-add (MulExtensionGate,
ArithmeticExtensionGate), a division by a witness-hinted inverse, a 64-bit
split and a bit sum (BaseSumGate), an exponentiation (ExponentiationGate),
a random access (RandomAccessGate), base and extension alpha-reductions
(ReducingGate, ReducingExtensionGate), a coset interpolation of each kind
(LowDegreeInterpolationGate, HighDegreeInterpolationGate), base arithmetic
(ArithmeticGate) and a Poseidon permutation (PoseidonGate).
PoseidonMdsGate, which no gadget places, goes in with ``add_gate``.  Its
inputs come from ``np.random.default_rng(seed)``; four hashes of its
results are the public inputs.

``place_gate_mix`` takes any builder and PartialWitness with these
gadgets, so that the JAX package's builder can build the same circuit
(the tests hold the two against each other); ``build_gate_mix_circuit``
builds it with the port's.
"""
from __future__ import annotations

import numpy as np

from ..field import goldilocks as gl
from ..gates.advanced import PoseidonMdsGate
from ..iop.witness import PartialWitness
from ..plonk.circuit_builder import CircuitBuilder
from ..plonk.config import CircuitConfig

SUBGROUP_BITS = 3          # the interpolations' cosets: 8 points
ACCESS_BITS = 3            # the random access: a list of 8
EXPONENT = 0x1F2E3D4C5B    # a 37-bit exponent
REDUCE_BASE_TERMS = 24     # more than an ArithmeticExtensionGate's ops + 1
REDUCE_EXT_TERMS = 14


def _ext(builder, pw, rng):
    t = builder.add_virtual_extension_target()
    for x in t:
        pw.set_target(x, int(rng.integers(1, gl.P, dtype=np.uint64)))
    return t


def _base(builder, pw, rng, high=gl.P):
    t = builder.add_virtual_target()
    pw.set_target(t, int(rng.integers(1, high, dtype=np.uint64)))
    return t


def place_gate_mix(builder, pw, rng, mds_gate, reducing_factor) -> list:
    """One copy of the mix on `builder`, its inputs set in `pw` from the
    numpy Generator `rng`; `mds_gate` is a PoseidonMdsGate and
    `reducing_factor` the ReducingFactorTarget class of the builder's
    package.  Returns the 4 targets of the copy's digest."""
    a, b = _ext(builder, pw, rng), _ext(builder, pw, rng)
    x = _base(builder, pw, rng)
    idx = _base(builder, pw, rng, 1 << ACCESS_BITS)

    # extension arithmetic and a division (QuotientGeneratorExtension)
    ab = builder.mul_extension(a, b)
    abab = builder.mul_add_extension(a, b, ab)
    q = builder.div_extension(abab, b)
    s = builder.sub_extension(builder.add_extension(q, a), ab)

    # base arithmetic, a split, a bit sum and an exponentiation
    bits = builder.split_le(x, 64)
    low = builder.le_sum(bits[:30])
    y = builder.exp_u64(x, EXPONENT)
    z = builder.mul_add(y, low, x)

    # a random access into 8 of the values so far
    items = [x, y, z, low, a[0], b[1], ab[0], s[1]]
    picked = builder.random_access(idx, items)

    # alpha-reductions of base and extension terms
    base_terms = (bits[30:30 + REDUCE_BASE_TERMS - 4]
                  + [picked, y, z, low])
    red = reducing_factor(s).reduce_base(base_terms, builder)
    ext_terms = [a, b, ab, abab, q, s, red]
    ext_terms += [builder.mul_extension(t, red) for t in ext_terms]
    red_ext = reducing_factor(q).reduce(ext_terms[:REDUCE_EXT_TERMS],
                                        builder)

    # coset interpolations of each kind, at the same point
    values = [_ext(builder, pw, rng) for _ in range(1 << SUBGROUP_BITS)]
    shift = _base(builder, pw, rng)
    ev_low = builder.interpolate_coset(SUBGROUP_BITS, shift, values, red_ext)
    ev_high = builder.interpolate_coset(SUBGROUP_BITS, shift, values,
                                        red_ext, high_degree=True)

    # Poseidon's MDS layer on extension values, placed as a gate
    row = builder.add_gate(mds_gate, [])
    mds_in = [a, b, ab, abab, q, s, red, red_ext, ev_low, ev_high,
              values[0], values[1]]
    for i, t in enumerate(mds_in):
        r = mds_gate.wires_input(i)
        builder.connect_extension(t, (("w", row, r.start),
                                      ("w", row, r.start + 1)))
    mds_out = [("w", row, mds_gate.wires_output(i).start) for i in range(12)]

    # a permutation of the results, then a hash of everything
    perm = builder.permute([picked, y, z, low] + mds_out[:8])
    return builder.hash_n_to_hash_no_pad(
        perm[:4] + list(ev_low) + list(ev_high) + mds_out[8:]
        + [builder.sub(ev_low[0], ev_high[0])])


def build_gate_mix_circuit(copies: int = 1, seed: int = 0, device=None):
    """(CircuitData, PartialWitness, the number of gates before padding)
    of `copies` copies of the mix under standard_recursion_config, the
    inputs from numpy seed `seed`; the digests of the copies are the
    public inputs.  ``device`` goes to CircuitBuilder.build."""
    from ..gadgets.reducing import ReducingFactorTarget
    builder = CircuitBuilder(CircuitConfig.standard_recursion_config())
    pw = PartialWitness()
    rng = np.random.default_rng(seed)
    for _ in range(copies):
        builder.register_public_inputs(place_gate_mix(
            builder, pw, rng, PoseidonMdsGate(), ReducingFactorTarget))
    n_gates = builder.num_gates()
    return builder.build(device=device), pw, n_gates
