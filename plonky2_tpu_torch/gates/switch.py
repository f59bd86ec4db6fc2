"""The conditional-swap gate (the port's copy of plonky2_tpu/gates/switch.py;
reference waksman/src/gates/switch.rs).

Its generator runs both ways: from the inputs and the outputs it derives
the switch bit, from the inputs and the switch bit the outputs.
"""
from __future__ import annotations

from typing import List

from ..iop.generator import SimpleGenerator
from .gate import Gate


class SwitchGate(Gate):
    def __init__(self, num_copies: int, chunk_size: int):
        self.num_copies = num_copies
        self.chunk_size = chunk_size

    @staticmethod
    def new_from_config(config, chunk_size: int) -> "SwitchGate":
        num_copies = config.num_routed_wires // (4 * chunk_size + 1)
        return SwitchGate(num_copies, chunk_size)

    def id(self):
        return (f"SwitchGate {{ chunk_size: {self.chunk_size}, num_copies: "
                f"{self.num_copies}, _phantom: PhantomData"
                f"<plonky2_field::goldilocks_field::GoldilocksField> }}<D=2>")

    def _base(self, copy: int) -> int:
        return copy * (4 * self.chunk_size + 1)

    def wire_first_input(self, copy, element):
        return self._base(copy) + element

    def wire_second_input(self, copy, element):
        return self._base(copy) + self.chunk_size + element

    def wire_first_output(self, copy, element):
        return self._base(copy) + 2 * self.chunk_size + element

    def wire_second_output(self, copy, element):
        return self._base(copy) + 3 * self.chunk_size + element

    def wire_switch_bool(self, copy):
        return self._base(copy) + 4 * self.chunk_size

    def eval_unfiltered(self, alg, vars):
        constraints = []
        one = alg.one()
        for c in range(self.num_copies):
            switch = vars.local_wires[self.wire_switch_bool(c)]
            not_switch = alg.sub(one, switch)
            for e in range(self.chunk_size):
                fi = vars.local_wires[self.wire_first_input(c, e)]
                si = vars.local_wires[self.wire_second_input(c, e)]
                fo = vars.local_wires[self.wire_first_output(c, e)]
                so = vars.local_wires[self.wire_second_output(c, e)]
                constraints.append(alg.mul(switch, alg.sub(fi, so)))
                constraints.append(alg.mul(switch, alg.sub(si, fo)))
                constraints.append(alg.mul(not_switch, alg.sub(fi, fo)))
                constraints.append(alg.mul(not_switch, alg.sub(si, so)))
        return constraints

    def generators(self, row, local_constants):
        return [SwitchGenerator(row, self, c) for c in range(self.num_copies)]

    def num_wires(self):
        return self.wire_switch_bool(self.num_copies - 1) + 1

    def num_constants(self):
        return 0

    def degree(self):
        return 2

    def num_constraints(self):
        return 4 * self.num_copies * self.chunk_size

    def num_ops(self):
        return self.num_copies


class SwitchGenerator(SimpleGenerator):
    """Runs both ways (its own ``watch_list`` and ``run``, not a simple
    generator's): once the inputs and either the outputs or the switch bit
    are set."""

    def __init__(self, row, gate: SwitchGate, copy: int):
        self.row = row
        self.gate = gate
        self.copy = copy

    def _wires(self, fn) -> List:
        return [("w", self.row, fn(self.copy, e))
                for e in range(self.gate.chunk_size)]

    def watch_list(self):
        g = self.gate
        return (self._wires(g.wire_first_input)
                + self._wires(g.wire_second_input)
                + self._wires(g.wire_first_output)
                + self._wires(g.wire_second_output)
                + [("w", self.row, g.wire_switch_bool(self.copy))])

    def run(self, witness, out, rng=None) -> bool:
        g = self.gate
        fi = self._wires(g.wire_first_input)
        si = self._wires(g.wire_second_input)
        fo = self._wires(g.wire_first_output)
        so = self._wires(g.wire_second_output)
        switch = ("w", self.row, g.wire_switch_bool(self.copy))

        ins_known = all(witness.contains(t) for t in fi + si)
        if not ins_known:
            return False
        outs_known = all(witness.contains(t) for t in fo + so)
        if outs_known:
            fiv = witness.get_targets(fi)
            siv = witness.get_targets(si)
            fov = witness.get_targets(fo)
            sov = witness.get_targets(so)
            if fov == fiv and sov == siv:
                out.append((switch, 0))
            elif fov == siv and sov == fiv:
                out.append((switch, 1))
            else:
                raise ValueError(
                    "No permutation from given inputs to given outputs")
            return True
        if witness.contains(switch):
            swap = witness.get_target(switch)
            src_first, src_second = (si, fi) if swap else (fi, si)
            for t, s in zip(fo, src_first):
                out.append((t, witness.get_target(s)))
            for t, s in zip(so, src_second):
                out.append((t, witness.get_target(s)))
            return True
        return False
