"""CircuitBuilder: gate placement, copy constraints and preprocessing
(the port's copy of the core of plonky2_tpu/plonk/circuit_builder.py;
reference plonky2/src/plonk/circuit_builder.rs).

It places gates, wires them, packs arithmetic into slots, hashes with
Poseidon gates and builds the circuit: the selector and constant
polynomials, the copy-constraint forest and the sigmas, the
constants-sigmas commitment, the generators indexed by the slots they
watch, and the circuit digest.  The commitment runs on the device through
fri/oracle.py:PolynomialBatch.from_values (kernels K3, K5, K1 and K2 on a
card).  It takes the JAX builder's gadget mixins for the extension field
(gadgets/extension.py), bit splits, exponentiation and random access
(gadgets/split.py), u32 arithmetic and comparison (gadgets/u32.py), big
integers (gadgets/biguint.py), foreign fields (gadgets/nonnative.py),
secp256k1 points (ecdsa/gadgets.py), Merkle proofs (gadgets/merkle.py),
coset interpolation (gates/interpolation.py), insertion
(gates/insertion.py), permutation networks and sorting
(gadgets/permutation.py), the FRI and PLONK verifiers in the circuit
(fri/recursive_verifier.py, plonk/recursive_verifier.py), conditional and
cyclic recursion (plonk/recursion.py), with the cyclic-recursion goal,
and tree recursion (plonk/tree_recursion.py), in the JAX builder's order.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import resolve_device
from ..ecdsa.gadgets import CurveGadgets
from ..field import goldilocks as gl
from ..fri.oracle import PolynomialBatch
from ..fri.recursive_verifier import FriRecursiveGadgets
from ..gadgets.biguint import BigUintGadgets
from ..gadgets.extension import ExtensionGadgets
from ..gadgets.merkle import MerkleGadgets
from ..gadgets.nonnative import NonNativeGadgets
from ..gadgets.permutation import PermutationGadgets
from ..gadgets.split import SplitGadgets
from ..gadgets.u32 import U32Gadgets
from ..gates.basic import (ArithmeticGate, ConstantGate, NoopGate,
                           PublicInputGate)
from ..gates.gate import Gate, selector_polynomials
from ..gates.insertion import InsertionGadgets
from ..gates.interpolation import InterpolationGadgets
from ..gates.poseidon_gate import (WIRE_SWAP, PoseidonGate, wire_input,
                                   wire_output)
from ..hash.hashers import POSEIDON_CONFIG
from ..iop.generator import (ConstantGenerator, CopyGenerator,
                             RandomValueGenerator)
from ..iop.target import Target, is_routable, target_index
from ..utils.bits import log2_ceil, log2_strict
from ..utils.timing import NoopTiming
from .circuit_data import (CircuitData, CommonCircuitData,
                           ProverOnlyCircuitData, VerifierOnlyCircuitData)
from .config import CircuitConfig
from .permutation import Forest
from .recursion import ConditionalRecursionGadgets
from .recursive_verifier import RecursionGadgets
from .tree_recursion import TreeRecursionGadgets


class GateInstance:
    __slots__ = ("gate", "constants")

    def __init__(self, gate: Gate, constants: List[int]):
        self.gate = gate
        self.constants = constants


class CircuitBuilder(ExtensionGadgets, SplitGadgets, U32Gadgets,
                     BigUintGadgets, NonNativeGadgets, CurveGadgets,
                     MerkleGadgets, InterpolationGadgets, InsertionGadgets,
                     PermutationGadgets, FriRecursiveGadgets,
                     RecursionGadgets, ConditionalRecursionGadgets,
                     TreeRecursionGadgets):
    def __init__(self, config: CircuitConfig):
        self.config = config
        self.gate_set: Dict[str, Gate] = {}
        self.gate_instances: List[GateInstance] = []
        self.public_inputs: List[Target] = []
        self.virtual_target_index = 0
        self.copy_constraints: List[Tuple[Target, Target]] = []
        self.generators: list = []
        self.constants_to_targets: Dict[int, Target] = {}
        self.targets_to_constants: Dict[Target, int] = {}
        self.base_arithmetic_results: Dict[tuple, Target] = {}
        self.arithmetic_ext_results: Dict[tuple, tuple] = {}
        # gate id -> {params: (gate index, next free slot)}
        self.current_slots: Dict[str, Dict[tuple, Tuple[int, int]]] = {}
        self.constant_generators: List[ConstantGenerator] = []
        # cyclic recursion (reference circuit_builder.rs:107-111)
        self.goal_common_data = None
        self.verifier_data_public_input = None

    # -- targets and wiring ---------------------------------------------

    def num_gates(self) -> int:
        return len(self.gate_instances)

    def add_virtual_target(self) -> Target:
        t = ("v", self.virtual_target_index)
        self.virtual_target_index += 1
        return t

    def add_virtual_targets(self, n: int) -> List[Target]:
        return [self.add_virtual_target() for _ in range(n)]

    def register_public_input(self, t: Target) -> None:
        self.public_inputs.append(t)

    def register_public_inputs(self, ts) -> None:
        for t in ts:
            self.register_public_input(t)

    def num_public_inputs(self) -> int:
        return len(self.public_inputs)

    def add_virtual_public_input(self) -> Target:
        t = self.add_virtual_target()
        self.register_public_input(t)
        return t

    def add_virtual_bool_target_safe(self) -> Target:
        b = self.add_virtual_target()
        self.assert_bool(b)
        return b

    def add_gate_to_gate_set(self, gate: Gate) -> None:
        """A gate in the gate set with no instance (to give a circuit the
        CommonCircuitData of a goal, reference circuit_builder.rs:333)."""
        self.gate_set.setdefault(gate.id(), gate)

    def add_gate(self, gate: Gate, constants: List[int]) -> int:
        if gate.num_wires() > self.config.num_wires:
            raise ValueError(f"{gate.id()} requires {gate.num_wires()} wires")
        if len(constants) > gate.num_constants():
            raise ValueError(f"{gate.id()} takes {gate.num_constants()} "
                             f"constants, got {len(constants)}")
        constants = (list(constants)
                     + [0] * (gate.num_constants() - len(constants)))
        row = len(self.gate_instances)
        for const_idx, wire_idx in gate.extra_constant_wires():
            self.constant_generators.append(
                ConstantGenerator(row, const_idx, wire_idx, 0))
        self.gate_set.setdefault(gate.id(), gate)
        self.gate_instances.append(GateInstance(gate, constants))
        return row

    def connect(self, x: Target, y: Target) -> None:
        for t in (x, y):
            if not is_routable(t, self.config.num_routed_wires):
                raise ValueError(f"{t} is not routable")
        self.copy_constraints.append((x, y))

    def generate_copy(self, src: Target, dst: Target) -> None:
        self.generators.append(CopyGenerator(src, dst))

    def assert_zero(self, x: Target) -> None:
        self.connect(x, self.zero())

    def assert_one(self, x: Target) -> None:
        self.connect(x, self.one())

    # -- constants ---------------------------------------------------------

    def constant(self, c: int) -> Target:
        c %= gl.P
        if c in self.constants_to_targets:
            return self.constants_to_targets[c]
        t = self.add_virtual_target()
        self.constants_to_targets[c] = t
        self.targets_to_constants[t] = c
        return t

    def zero(self) -> Target:
        return self.constant(0)

    def one(self) -> Target:
        return self.constant(1)

    def two(self) -> Target:
        return self.constant(2)

    def neg_one(self) -> Target:
        return self.constant(gl.P - 1)

    def target_as_constant(self, t: Target) -> Optional[int]:
        return self.targets_to_constants.get(t)

    # -- slot packing --------------------------------------------------------

    def find_slot(self, gate: Gate, params: List[int],
                  constants: List[int]) -> Tuple[int, int]:
        num_gates = self.num_gates()
        num_ops = gate.num_ops()
        slots = self.current_slots.setdefault(gate.id(), {})
        key = tuple(params)
        if key in slots:
            gate_idx, slot_idx = slots[key]
        else:
            self.add_gate(gate, list(constants))
            gate_idx, slot_idx = num_gates, 0
        if slot_idx == num_ops - 1:
            slots.pop(key, None)
        else:
            slots[key] = (gate_idx, slot_idx + 1)
        return gate_idx, slot_idx

    # -- base arithmetic (reference gadgets/arithmetic.rs) -------------------

    def arithmetic(self, const_0: int, const_1: int, m0: Target, m1: Target,
                   addend: Target) -> Target:
        const_0 %= gl.P
        const_1 %= gl.P
        special = self._arithmetic_special_cases(const_0, const_1, m0, m1,
                                                 addend)
        if special is not None:
            return special
        op = (const_0, const_1, m0, m1, addend)
        if op in self.base_arithmetic_results:
            return self.base_arithmetic_results[op]
        gate = ArithmeticGate.new_from_config(self.config)
        consts = [const_0, const_1]
        g, i = self.find_slot(gate, consts, consts)
        self.connect(m0, ("w", g, ArithmeticGate.wire_ith_multiplicand_0(i)))
        self.connect(m1, ("w", g, ArithmeticGate.wire_ith_multiplicand_1(i)))
        self.connect(addend, ("w", g, ArithmeticGate.wire_ith_addend(i)))
        result = ("w", g, ArithmeticGate.wire_ith_output(i))
        self.base_arithmetic_results[op] = result
        return result

    def _arithmetic_special_cases(self, c0, c1, m0, m1,
                                  addend) -> Optional[Target]:
        zero = self.zero()
        m0c = self.target_as_constant(m0)
        m1c = self.target_as_constant(m1)
        adc = self.target_as_constant(addend)
        first_zero = c0 == 0 or m0 == zero or m1 == zero
        second_zero = c1 == 0 or addend == zero
        first_const = 0 if first_zero else (
            (m0c * m1c * c0) % gl.P
            if (m0c is not None and m1c is not None) else None)
        second_const = 0 if second_zero else (
            (adc * c1) % gl.P if adc is not None else None)
        if first_const is not None and second_const is not None:
            return self.constant((first_const + second_const) % gl.P)
        if first_zero and c1 == 1:
            return addend
        if second_zero:
            if m0c == 1 and c0 == 1:
                return m1
            if m1c == 1 and c0 == 1:
                return m0
        return None

    def add(self, x: Target, y: Target) -> Target:
        return self.arithmetic(1, 1, x, self.one(), y)

    def sub(self, x: Target, y: Target) -> Target:
        return self.arithmetic(1, gl.P - 1, x, self.one(), y)

    def mul(self, x: Target, y: Target) -> Target:
        return self.arithmetic(1, 0, x, y, self.zero())

    def mul_add(self, x: Target, y: Target, z: Target) -> Target:
        return self.arithmetic(1, 1, x, y, z)

    def mul_const(self, c: int, x: Target) -> Target:
        return self.arithmetic(c, 0, x, self.one(), self.zero())

    def square(self, x: Target) -> Target:
        return self.mul(x, x)

    # -- Poseidon hashing (reference hashing.rs:15-61, poseidon.rs:672-711) --

    def permute(self, inputs: List[Target]) -> List[Target]:
        return self.permute_swapped(inputs, self.zero())

    def permute_swapped(self, inputs: List[Target],
                        swap: Target) -> List[Target]:
        if len(inputs) != 12:
            raise ValueError(f"a permutation takes 12 inputs, got "
                             f"{len(inputs)}")
        g = self.add_gate(PoseidonGate(), [])
        self.connect(swap, ("w", g, WIRE_SWAP))
        for i in range(12):
            self.connect(inputs[i], ("w", g, wire_input(i)))
        return [("w", g, wire_output(i)) for i in range(12)]

    def hash_n_to_m_no_pad(self, inputs: List[Target],
                           num_outputs: int) -> List[Target]:
        zero = self.zero()
        state = [zero] * 12
        for start in range(0, len(inputs), 8):
            chunk = inputs[start:start + 8]
            state = chunk + state[len(chunk):]
            state = self.permute(state)
        outputs = []
        while True:
            for i in range(8):
                outputs.append(state[i])
                if len(outputs) == num_outputs:
                    return outputs
            state = self.permute(state)

    def hash_n_to_hash_no_pad(self, inputs: List[Target]) -> List[Target]:
        return self.hash_n_to_m_no_pad(inputs, 4)

    def hash_or_noop(self, inputs: List[Target]) -> List[Target]:
        zero = self.zero()
        if len(inputs) <= 4:
            return list(inputs) + [zero] * (4 - len(inputs))
        return self.hash_n_to_hash_no_pad(inputs)

    # -- blinding and padding ------------------------------------------------

    def _blind_and_pad(self) -> None:
        if self.config.zero_knowledge:
            self._blind()
        while self.num_gates() & (self.num_gates() - 1):
            self.add_gate(NoopGate(), [])

    def _num_blinding_gates(self, degree_estimate: int) -> Tuple[int, int]:
        degree_bits_estimate = log2_strict(degree_estimate)
        fri_queries = self.config.fri_config.num_query_rounds
        params = self.config.fri_config.fri_params(degree_bits_estimate,
                                                   self.config.zero_knowledge)
        arities = [1 << x for x in params.reduction_arity_bits]
        total_fri_folding_points = sum(x - 1 for x in arities)
        prod = 1
        for x in arities:
            prod *= x
        final_poly_coeffs = degree_estimate // prod
        fri_openings = fri_queries * (1 + 2 * total_fri_folding_points
                                      + 2 * final_poly_coeffs)
        return 2 + fri_openings, 4 + fri_openings

    def _blinding_counts(self) -> Tuple[int, int]:
        num_gates = len(self.gate_instances)
        degree_estimate = 1 << log2_ceil(max(num_gates, 1))
        while True:
            regular, z = self._num_blinding_gates(degree_estimate)
            if num_gates + regular + 2 * z <= degree_estimate:
                return regular, z
            degree_estimate *= 2

    def _blind(self) -> None:
        regular, z = self._blinding_counts()
        for _ in range(regular):
            row = self.add_gate(NoopGate(), [])
            for w in range(self.config.num_wires):
                self.generators.append(RandomValueGenerator(("w", row, w)))
        for _ in range(z):
            g1 = self.add_gate(NoopGate(), [])
            g2 = self.add_gate(NoopGate(), [])
            for w in range(self.config.num_routed_wires):
                self.generators.append(RandomValueGenerator(("w", g1, w)))
                self.generate_copy(("w", g1, w), ("w", g2, w))

    # -- build (reference circuit_builder.rs:765-971) ------------------------

    def _constant_polys(self) -> np.ndarray:
        max_constants = max(g.num_constants() for g in self.gate_set.values())
        out = np.zeros((max_constants, len(self.gate_instances)),
                       dtype=np.uint64)
        for j, inst in enumerate(self.gate_instances):
            for k, c in enumerate(inst.constants):
                out[k, j] = c
        return out

    def _sigma_vecs(self, k_is, subgroup) -> Tuple[np.ndarray, Forest]:
        config = self.config
        forest = Forest(config.num_wires, config.num_routed_wires,
                        len(self.gate_instances))
        forest.init_slots(self.virtual_target_index)
        forest.merge_many(self.copy_constraints)
        forest.compress_paths()
        return forest.sigma_polys(k_is, subgroup), forest

    def _watch_index(self, forest: Forest,
                     degree: int) -> Dict[int, List[int]]:
        """Generator indices by the representative of each slot they
        watch, each list in generator order without repeats."""
        nw = self.config.num_wires
        parents = forest.parents
        by_watches: Dict[int, List[int]] = {}
        for i, gen in enumerate(self.generators):
            for watch in gen.watch_list():
                rep = int(parents[target_index(watch, nw, degree)])
                lst = by_watches.setdefault(rep, [])
                if not lst or lst[-1] != i:   # i's watches come together
                    lst.append(i)
        return by_watches

    def build_common(self) -> CommonCircuitData:
        """The CommonCircuitData that build() would give, without the
        sigmas, the commitment and the generator index: all that
        plonk/recursion.py:common_data_for_recursion reads of the circuits
        it builds.  The builder is finished as build() finishes it."""
        return self._finish_gates(POSEIDON_CONFIG)[0]

    def _finish_gates(self, gc):
        """Place the public-inputs hash, the constant gates and the
        padding; (CommonCircuitData naming the hasher configuration `gc`,
        the constant polynomials' values)."""
        config = self.config
        rate_bits = config.fri_config.rate_bits
        cap_height = config.fri_config.cap_height
        # the public-inputs hash in the circuit, routed to a PublicInputGate
        num_public_inputs = len(self.public_inputs)
        pi_hash = self.hash_n_to_hash_no_pad(list(self.public_inputs))
        pi_gate = self.add_gate(PublicInputGate(), [])
        for i, hp in enumerate(pi_hash):
            self.connect(hp, ("w", pi_gate, i))
        for w in range(4, config.num_wires):
            self.generators.append(RandomValueGenerator(("w", pi_gate, w)))

        # the constant gates
        while len(self.constants_to_targets) > len(self.constant_generators):
            self.add_gate(ConstantGate(config.num_constants), [])
        for (c, t), cg in zip(sorted(self.constants_to_targets.items(),
                                     key=lambda kv: kv[0]),
                              self.constant_generators):
            self.gate_instances[cg.row].constants[cg.constant_index] = c
            self.connect(("w", cg.row, cg.wire_index), t)
            cg.constant = c
            self.generators.append(cg)

        # cyclic recursion: pad to the goal's degree, so that the circuit's
        # CommonCircuitData is the goal's
        if self.goal_common_data is not None:
            goal_degree = self.goal_common_data.degree()
            if self.num_gates() > goal_degree:
                raise ValueError(
                    f"circuit has {self.num_gates()} gates, more than the "
                    f"cyclic goal degree {goal_degree}")
            while self.num_gates() < goal_degree:
                self.add_gate(NoopGate(), [])

        self._blind_and_pad()
        degree_bits = log2_strict(len(self.gate_instances))
        fri_params = config.fri_config.fri_params(degree_bits,
                                                  config.zero_knowledge)
        if fri_params.total_arities() > degree_bits + rate_bits - cap_height:
            raise ValueError("FRI total reduction arity is too large.")

        quotient_degree_factor = config.max_quotient_degree_factor
        gates = sorted(self.gate_set.values(),
                       key=lambda g: (g.degree(), g.id()))
        selector_polys, selectors_info = selector_polynomials(
            gates, self.gate_instances, quotient_degree_factor + 1)
        constant_vecs = np.concatenate(
            [selector_polys, self._constant_polys()], axis=0)
        common = CommonCircuitData(
            config=config, fri_params=fri_params, gates=gates,
            selectors_info=selectors_info,
            quotient_degree_factor=quotient_degree_factor,
            num_gate_constraints=max(g.num_constraints() for g in gates),
            num_constants=constant_vecs.shape[0],
            num_public_inputs=num_public_inputs,
            k_is=[pow(gl.MULTIPLICATIVE_GROUP_GENERATOR, i, gl.P)
                  for i in range(config.num_routed_wires)],
            num_partial_products=(-(-config.num_routed_wires
                                    // quotient_degree_factor) - 1),
            hasher_name=gc.name)
        if (self.goal_common_data is not None
                and self.goal_common_data != common):
            raise ValueError("The expected circuit data passed to cyclic "
                             "recursion did not match the actual circuit")
        return common, constant_vecs

    def build(self, gc=None, device=None, timing=None) -> CircuitData:
        """The circuit's data under the hasher configuration `gc`
        (hash/hashers.py, Poseidon unless given: reference build::<C>'s
        GenericConfig), which makes the constants-sigmas commitment's tree
        and the circuit digest and which the CommonCircuitData names; the
        commitment's LDE runs on `device` (default cuda).
        ``timing.scope(name)`` wraps each stage when given."""
        timing = timing if timing is not None else NoopTiming()
        dev = resolve_device(device)
        gc = gc if gc is not None else POSEIDON_CONFIG
        config = self.config

        with timing.scope("gates and wiring"):
            common, constant_vecs = self._finish_gates(gc)
            degree = common.degree()
            degree_bits = common.degree_bits()

        with timing.scope("forest and sigmas"):
            subgroup = gl.two_adic_subgroup(degree_bits)
            sigma_vecs, forest = self._sigma_vecs(common.k_is, subgroup)

        with timing.scope("constants-sigmas commitment"):
            constants_sigmas_commitment = PolynomialBatch.from_values(
                np.concatenate([constant_vecs, sigma_vecs], axis=0),
                config.fri_config.rate_bits, False,
                config.fri_config.cap_height, device=dev, hasher=gc)

        with timing.scope("generator index"):
            # a slot gate's unused operations get no generator
            incomplete = {}
            for slots in self.current_slots.values():
                for (gate_idx, op) in slots.values():
                    incomplete[gate_idx] = op
            for row, inst in enumerate(self.gate_instances):
                gens = inst.gate.generators(row, inst.constants)
                if row in incomplete:
                    gens = gens[:incomplete[row]]
                self.generators.extend(gens)
            by_watches = self._watch_index(forest, degree)

        with timing.scope("digest"):
            # the cap, the digest of an empty domain separator, the
            # degree bits
            cap = constants_sigmas_commitment.merkle_tree.cap
            circuit_digest = gc.hash_no_pad_elements(np.concatenate([
                cap.digests.reshape(-1), gc.hash_pad_elements([]),
                np.array([degree_bits], dtype=np.uint64)]))

        prover_only = ProverOnlyCircuitData(
            generators=self.generators,
            generator_indices_by_watches=by_watches,
            constants_sigmas_commitment=constants_sigmas_commitment,
            sigmas=sigma_vecs.T.copy(),  # (degree, num_routed)
            subgroup=subgroup, public_inputs=self.public_inputs,
            representative_map=forest.parents,
            circuit_digest=circuit_digest)
        verifier_only = VerifierOnlyCircuitData(
            constants_sigmas_cap=cap, circuit_digest=circuit_digest)
        return CircuitData(prover_only=prover_only,
                           verifier_only=verifier_only, common=common)
