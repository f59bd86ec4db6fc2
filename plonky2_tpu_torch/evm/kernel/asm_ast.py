"""The port's copy of plonky2_tpu/evm/kernel/asm_ast.py.

Kernel assembly AST (reference evm/src/cpu/kernel/ast.rs)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple, Union


@dataclass
class MacroDef:
    name: str
    params: List[str]
    body: List["Item"]


@dataclass
class MacroCall:
    name: str
    args: List["PushTarget"]


@dataclass
class Repeat:
    count: int
    body: List["Item"]


@dataclass
class StackPlaceholder:
    """Left-hand-side name, covering `size` stack slots
    (reference ast.rs:43-44)."""
    name: str
    size: int = 1


@dataclass
class Literal:
    value: int


@dataclass
class Label:
    name: str


@dataclass
class MacroLabel:
    name: str


@dataclass
class MacroVar:
    name: str


@dataclass
class Constant:
    name: str


@dataclass
class Identifier:
    """Right-hand-side of %stack: a named item or a label
    (reference ast.rs:47-55)."""
    name: str


PushTarget = Union[Literal, Label, MacroLabel, MacroVar, Constant]
StackReplacement = Union[Literal, Label, MacroLabel, MacroVar, Constant,
                         Identifier]


@dataclass
class StackManipulation:
    before: List[StackPlaceholder]
    after: List[StackReplacement]


@dataclass
class GlobalLabelDeclaration:
    name: str


@dataclass
class LocalLabelDeclaration:
    name: str


@dataclass
class MacroLabelDeclaration:
    name: str


@dataclass
class Push:
    target: PushTarget


@dataclass
class ProverInput:
    fn: Tuple[str, ...]


@dataclass
class StandardOp:
    mnemonic: str


@dataclass
class Bytes:
    data: List[int]


@dataclass
class Jumptable:
    labels: List[str]


Item = Union[MacroDef, MacroCall, Repeat, StackManipulation,
             GlobalLabelDeclaration, LocalLabelDeclaration,
             MacroLabelDeclaration, Push, ProverInput, StandardOp, Bytes,
             Jumptable]


@dataclass
class File:
    body: List[Item] = field(default_factory=list)
