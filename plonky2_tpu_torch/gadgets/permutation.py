"""AS-Waksman permutation networks and sorting in the circuit (the port's
copy of plonky2_tpu/gadgets/permutation.py; reference
waksman/src/{permutation,sorting,bimap}.rs).

``assert_permutation`` proves two lists of wire chunks are permutations of
one another via a recursive switching network; routing happens in a witness
generator that propagates switch settings across the two layers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from ..gates.assert_le import AssertLessThanGate
from ..gates.switch import SwitchGate
from ..iop.generator import SimpleGenerator
from ..iop.target import Target


def bimap_from_lists(a: List[tuple], b: List[tuple]):
    """index bijection between equal multisets with unique elements
    (reference bimap.rs)."""
    if sorted(a) != sorted(b):
        raise ValueError("Lists must be permutations of one another")
    b_index = {}
    for j, v in enumerate(b):
        if v in b_index:
            raise ValueError("duplicate values not supported")
        b_index[v] = j
    left_to_right = [b_index[v] for v in a]
    right_to_left = [0] * len(b)
    for i, j in enumerate(left_to_right):
        right_to_left[j] = i
    return left_to_right, right_to_left


class PermutationGenerator(SimpleGenerator):
    def __init__(self, a, b, a_switches, b_switches):
        self.a = a
        self.b = b
        self.a_switches = a_switches
        self.b_switches = b_switches

    def dependencies(self):
        return [t for chunk in self.a + self.b for t in chunk]

    def run_once(self, witness, out):
        a_values = [tuple(witness.get_target(t) for t in chunk)
                    for chunk in self.a]
        b_values = [tuple(witness.get_target(t) for t in chunk)
                    for chunk in self.b]
        _route(a_values, b_values, self.a_switches, self.b_switches, witness,
               out)


def _route(a_values, b_values, a_switches, b_switches, witness, out):
    """AS-Waksman routing (reference permutation.rs:174-333)."""
    n = len(a_values)
    even = n % 2 == 0
    left_to_right, right_to_left = bimap_from_lists(a_values, b_values)
    switches = [a_switches, b_switches]
    newly_set = [dict(), dict()]  # switch index -> bool (value set)

    def ab_map_by_side(side, index):
        return left_to_right[index] if side == 0 else right_to_left[index]

    partial_routes = [dict(), dict()]

    def enqueue_other_side(side, this_i, subnet: bool):
        other_side = 1 - side
        other_i = ab_map_by_side(side, this_i)
        other_switch_i = other_i // 2
        if other_switch_i >= len(switches[other_side]):
            return
        if (witness.contains(switches[other_side][other_switch_i])
                or other_switch_i in newly_set[other_side]):
            return
        other_i_sibling = 4 * other_switch_i + 1 - other_i
        if other_i_sibling in partial_routes[other_side]:
            if subnet == partial_routes[other_side][other_i_sibling]:
                raise ValueError("Routing conflict (should never happen)")
        else:
            old = partial_routes[other_side].get(other_i)
            if old is not None and subnet != old:
                raise ValueError("Routing conflict (should never happen)")
            partial_routes[other_side][other_i] = subnet

    if even:
        enqueue_other_side(1, n - 2, False)
        enqueue_other_side(1, n - 1, True)
    else:
        enqueue_other_side(0, n - 1, True)
        enqueue_other_side(1, n - 1, True)

    def route_switch(side, switch_index, swap: bool):
        out.append((switches[side][switch_index], int(swap)))
        newly_set[side][switch_index] = swap
        this_i_1 = switch_index * 2
        enqueue_other_side(side, this_i_1, swap)
        enqueue_other_side(side, this_i_1 + 1, not swap)

    scan_index = [0, 0]
    while scan_index[0] < len(switches[0]) or scan_index[1] < len(switches[1]):
        for side in (0, 1):
            if partial_routes[side]:
                for this_i, subnet in list(partial_routes[side].items()):
                    this_first_switch_input = this_i % 2 == 0
                    swap = this_first_switch_input == subnet
                    route_switch(side, this_i // 2, swap)
                partial_routes[side].clear()
            else:
                while (scan_index[side] < len(switches[side])
                       and (witness.contains(switches[side][scan_index[side]])
                            or scan_index[side] in newly_set[side])):
                    scan_index[side] += 1
                if scan_index[side] < len(switches[side]):
                    route_switch(side, scan_index[side], False)
                    scan_index[side] += 1


@dataclass
class MemoryOpTarget:
    is_write: Target
    address: Target
    timestamp: Target
    value: Target


class PermutationGadgets:
    """Mixed into CircuitBuilder."""

    def _create_switch(self, a1: List[Target],
                       a2: List[Target]) -> Tuple[Target, list, list]:
        chunk_size = len(a1)
        gate = SwitchGate.new_from_config(self.config, chunk_size)
        row, copy = self.find_slot(gate, [chunk_size], [])
        c, d = [], []
        for e in range(chunk_size):
            self.connect(a1[e], ("w", row, gate.wire_first_input(copy, e)))
            self.connect(a2[e], ("w", row, gate.wire_second_input(copy, e)))
            c.append(("w", row, gate.wire_first_output(copy, e)))
            d.append(("w", row, gate.wire_second_output(copy, e)))
        return ("w", row, gate.wire_switch_bool(copy)), c, d

    def assert_permutation(self, a: List[List[Target]],
                           b: List[List[Target]]) -> None:
        if len(a) != len(b):
            raise ValueError("Permutation must have same number of inputs "
                             "and outputs")
        if len(a) == 0:
            return
        if len(a[0]) != len(b[0]):
            raise ValueError("Chunk size must be the same")
        if len(a) == 1:
            for x, y in zip(a[0], b[0]):
                self.connect(x, y)
        elif len(a) == 2:
            _, out1, out2 = self._create_switch(a[0], a[1])
            for x, y in zip(b[0], out1):
                self.connect(x, y)
            for x, y in zip(b[1], out2):
                self.connect(x, y)
        else:
            self._assert_permutation_helper(a, b)

    def _assert_permutation_helper(self, a, b) -> None:
        n = len(a)
        even = n % 2 == 0
        child_1_a, child_1_b, child_2_a, child_2_b = [], [], [], []
        a_num_switches = n // 2
        b_num_switches = a_num_switches - 1 if even else a_num_switches

        a_switches, b_switches = [], []
        for i in range(a_num_switches):
            switch, out1, out2 = self._create_switch(a[2 * i], a[2 * i + 1])
            a_switches.append(switch)
            child_1_a.append(out1)
            child_2_a.append(out2)
        for i in range(b_num_switches):
            switch, out1, out2 = self._create_switch(b[2 * i], b[2 * i + 1])
            b_switches.append(switch)
            child_1_b.append(out1)
            child_2_b.append(out2)

        if even:
            child_1_b.append(b[n - 2])
            child_2_b.append(b[n - 1])
        else:
            child_2_a.append(a[n - 1])
            child_2_b.append(b[n - 1])

        self.assert_permutation(child_1_a, child_1_b)
        self.assert_permutation(child_2_a, child_2_b)
        self.generators.append(
            PermutationGenerator(a, b, a_switches, b_switches))

    # -- sorting (reference sorting.rs) ---------------------------------------

    def assert_le(self, lhs: Target, rhs: Target, bits: int,
                  num_chunks: int) -> None:
        gate = AssertLessThanGate(bits, num_chunks)
        row = self.add_gate(gate, [])
        self.connect(lhs, ("w", row, gate.wire_first_input()))
        self.connect(rhs, ("w", row, gate.wire_second_input()))

    def sort_memory_ops(self, ops: List[MemoryOpTarget], address_bits: int,
                        timestamp_bits: int) -> List[MemoryOpTarget]:
        n = len(ops)
        combined_bits = address_bits + timestamp_bits
        chunk_bits = 3
        num_chunks = -(-combined_bits // chunk_bits)

        output = [MemoryOpTarget(is_write=self.add_virtual_target(),
                                 address=self.add_virtual_target(),
                                 timestamp=self.add_virtual_target(),
                                 value=self.add_virtual_target())
                  for _ in range(n)]

        two_n = self.constant(1 << timestamp_bits)
        combined = [self.mul_add(op.address, two_n, op.timestamp)
                    for op in output]
        for i in range(1, n):
            self.assert_le(combined[i - 1], combined[i], combined_bits,
                           num_chunks)

        a_chunks = [[op.address, op.timestamp, op.is_write, op.value]
                    for op in ops]
        b_chunks = [[op.address, op.timestamp, op.is_write, op.value]
                    for op in output]
        self.assert_permutation(a_chunks, b_chunks)

        self.generators.append(MemoryOpSortGenerator(list(ops), output))
        return output


class MemoryOpSortGenerator(SimpleGenerator):
    def __init__(self, input_ops, output_ops):
        self.input_ops = input_ops
        self.output_ops = output_ops

    def dependencies(self):
        return [t for op in self.input_ops
                for t in (op.is_write, op.address, op.timestamp, op.value)]

    def run_once(self, witness, out):
        ops = [(witness.get_target(op.address),
                witness.get_target(op.timestamp),
                witness.get_target(op.is_write),
                witness.get_target(op.value)) for op in self.input_ops]
        ops.sort(key=lambda o: (o[0], o[1]))
        for op_t, (addr, ts, w, v) in zip(self.output_ops, ops):
            out.append((op_t.address, addr))
            out.append((op_t.timestamp, ts))
            out.append((op_t.is_write, w))
            out.append((op_t.value, v))
