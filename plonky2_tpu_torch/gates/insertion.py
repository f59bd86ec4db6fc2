"""The insertion gate and gadget: a value inserted into a list at an index
that the witness chooses (the port's copy of plonky2_tpu/gates/insertion.py;
reference insertion/src/{insertion_gate,insert_gadget}.rs)."""
from __future__ import annotations

from typing import List

from ..field import goldilocks as gl
from ..gadgets.extension import ext_from_range
from ..iop.generator import SimpleGenerator
from .ext_algebra import ea_add, ea_scalar_mul, ea_sub, get_local_ext
from .gate import Gate

D = 2


class InsertionGate(Gate):
    def __init__(self, vec_size: int):
        self.vec_size = vec_size

    def id(self):
        return (f"InsertionGate {{ vec_size: {self.vec_size}, _phantom: "
                f"PhantomData<plonky2_field::goldilocks_field::"
                f"GoldilocksField> }}<D=2>")

    def wires_insertion_index(self) -> int:
        return 0

    def wires_element_to_insert(self) -> range:
        return range(1, D + 1)

    def wires_original_list_item(self, i: int) -> range:
        start = (i + 1) * D + 1
        return range(start, start + D)

    def _start_of_output_wires(self) -> int:
        return (self.vec_size + 1) * D + 1

    def wires_output_list_item(self, i: int) -> range:
        start = self._start_of_output_wires() + i * D
        return range(start, start + D)

    def _start_of_intermediate_wires(self) -> int:
        return self._start_of_output_wires() + (self.vec_size + 1) * D

    def wire_equality_dummy_for_round_r(self, r: int) -> int:
        return self._start_of_intermediate_wires() + r

    def wire_insert_here_for_round_r(self, r: int) -> int:
        return self._start_of_intermediate_wires() + (self.vec_size + 1) + r

    def eval_unfiltered(self, alg, vars):
        insertion_index = vars.local_wires[self.wires_insertion_index()]
        list_items = [get_local_ext(vars, self.wires_original_list_item(i))
                      for i in range(self.vec_size)]
        output_items = [get_local_ext(vars, self.wires_output_list_item(i))
                        for i in range(self.vec_size + 1)]
        element = get_local_ext(vars, self.wires_element_to_insert())

        constraints = []
        one = alg.one()
        already_inserted = alg.zero()
        for r in range(self.vec_size + 1):
            difference = alg.sub(alg.const(r), insertion_index)
            equality_dummy = vars.local_wires[
                self.wire_equality_dummy_for_round_r(r)]
            insert_here = vars.local_wires[
                self.wire_insert_here_for_round_r(r)]

            constraints.append(alg.sub(alg.mul(difference, equality_dummy),
                                       alg.sub(one, insert_here)))
            constraints.append(alg.mul(insert_here, difference))

            new_item = ea_scalar_mul(alg, element, insert_here)
            if r > 0:
                new_item = ea_add(alg, new_item,
                                  ea_scalar_mul(alg, list_items[r - 1],
                                                already_inserted))
            already_inserted = alg.add(already_inserted, insert_here)
            if r < self.vec_size:
                not_inserted = alg.sub(one, already_inserted)
                new_item = ea_add(alg, new_item,
                                  ea_scalar_mul(alg, list_items[r],
                                                not_inserted))
            constraints.extend(ea_sub(alg, new_item, output_items[r]))
        return constraints

    def generators(self, row, local_constants):
        return [InsertionGenerator(row, self)]

    def num_wires(self):
        return self.wire_insert_here_for_round_r(self.vec_size) + 1

    def num_constants(self):
        return 0

    def degree(self):
        return 2

    def num_constraints(self):
        return (self.vec_size + 1) * (2 + D)


class InsertionGenerator(SimpleGenerator):
    def __init__(self, row, gate: InsertionGate):
        self.row = row
        self.gate = gate

    def dependencies(self):
        g = self.gate
        cols = [g.wires_insertion_index()]
        cols += list(g.wires_element_to_insert())
        for i in range(g.vec_size):
            cols += list(g.wires_original_list_item(i))
        return [("w", self.row, c) for c in cols]

    def run_once(self, witness, out):
        g = self.gate
        w = lambda c: witness.get_target(("w", self.row, c))  # noqa: E731
        wext = lambda r: (w(r.start), w(r.start + 1))  # noqa: E731

        index = w(g.wires_insertion_index())
        element = wext(g.wires_element_to_insert())
        orig = [wext(g.wires_original_list_item(i)) for i in range(g.vec_size)]
        if index > g.vec_size:
            raise ValueError(f"insertion index {index} out of range")
        new_vec = orig[:index] + [element] + orig[index:]

        for r in range(g.vec_size + 1):
            diff = (r - index) % gl.P
            eq_dummy = pow(diff, gl.P - 2, gl.P) if diff else 1
            insert_here = 1 if r == index else 0
            out.append((("w", self.row, g.wire_equality_dummy_for_round_r(r)),
                        eq_dummy))
            out.append((("w", self.row, g.wire_insert_here_for_round_r(r)),
                        insert_here))
            rr = g.wires_output_list_item(r)
            out.append((("w", self.row, rr.start), new_vec[r][0]))
            out.append((("w", self.row, rr.start + 1), new_vec[r][1]))


class InsertionGadgets:
    """Mixed into CircuitBuilder (reference insert_gadget.rs)."""

    def insert(self, index, element, vec: List) -> List:
        """Insert extension-target `element` into `vec` at position `index`
        (a Target); returns the new list of vec_size+1 extension targets."""
        vec_size = len(vec)
        gate = InsertionGate(vec_size)
        row = self.add_gate(gate, [])
        self.connect(index, ("w", row, gate.wires_insertion_index()))
        self.connect_extension(
            element, ext_from_range(row, gate.wires_element_to_insert()))
        for i, v in enumerate(vec):
            self.connect_extension(
                v, ext_from_range(row, gate.wires_original_list_item(i)))
        return [ext_from_range(row, gate.wires_output_list_item(i))
                for i in range(vec_size + 1)]
