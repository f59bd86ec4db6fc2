"""Targets and wires (the port's copy of plonky2_tpu/iop/target.py;
reference plonky2/src/iop/target.rs, wire.rs).

A target is a wire (row, column) of the witness grid or a virtual target
used only while the witness is generated, as plain tuples:
("w", row, column) | ("v", index).
"""
from __future__ import annotations

from typing import Tuple

Target = Tuple  # ("w", row, col) or ("v", index)


def is_routable(t: Target, num_routed_wires: int) -> bool:
    if t[0] == "v":
        return True
    return t[2] < num_routed_wires


def target_index(t: Target, num_wires: int, degree: int) -> int:
    """The copy-constraint forest's flat index: row * num_wires + column
    for a wire, degree * num_wires + index for a virtual target
    (reference target.rs:36-41)."""
    if t[0] == "w":
        return t[1] * num_wires + t[2]
    return degree * num_wires + t[1]
