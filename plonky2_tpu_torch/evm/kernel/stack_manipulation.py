"""The port's copy of plonky2_tpu/evm/kernel/stack_manipulation.py.

%stack directive expansion
(reference evm/src/cpu/kernel/stack/stack_manipulation.rs).

Transforms `%stack (a, b: 2) -> (b, 5, a)` into a concrete PUSH/POP/DUP/SWAP
sequence.  The reference runs an A*-search for a minimal instruction
sequence (stack_manipulation.rs:60-140); we use a direct constructive
schedule instead — push every replacement on top (DUPing named slots,
PUSHing literals/labels), delete the consumed originals underneath, then
repair the block order with a transposition sort.  Correct for any pattern
(depths permitting), merely not always minimal; the peephole optimizer
reclaims the common redundancies."""
from __future__ import annotations

from typing import List, Tuple

from . import asm_ast as ast


def expand_stack_manipulation(body: List[ast.Item]) -> List[ast.Item]:
    out: List[ast.Item] = []
    for item in body:
        if isinstance(item, ast.StackManipulation):
            out.extend(_expand(item))
        else:
            out.append(item)
    return out


def _expand(item: ast.StackManipulation) -> List[ast.Item]:
    # name the original slots, top first; a block placeholder of size k
    # expands to k consecutive slots
    slots: List[Tuple[str, int]] = []
    blocks = {}
    for ph in item.before:
        blocks[ph.name] = [(ph.name, k) for k in range(ph.size)]
        slots.extend(blocks[ph.name])

    # the goal stack, top first: each entry is a slot, a literal, or a label
    goal: List[object] = []
    for rep in item.after:
        if isinstance(rep, ast.Identifier):
            if rep.name in blocks:
                goal.extend(blocks[rep.name])
            else:  # a label (reference ast.rs:47-50)
                goal.append(ast.Label(rep.name))
        elif isinstance(rep, (ast.Literal, ast.Label)):
            goal.append(rep)
        else:
            raise ValueError(f"unresolved stack replacement: {rep}")

    ops: List[ast.Item] = []
    model: List[object] = list(slots)

    def emit_swap(depth: int):
        assert 1 <= depth <= 16, f"SWAP{depth} exceeds EVM depth"
        ops.append(ast.StandardOp(f"SWAP{depth}"))
        model[0], model[depth] = model[depth], model[0]

    # push the goal items in reverse so the block lands in order on top
    for entry in reversed(goal):
        if isinstance(entry, tuple):
            depth = model.index(entry) + 1
            assert depth <= 16, f"DUP{depth} exceeds EVM depth"
            ops.append(ast.StandardOp(f"DUP{depth}"))
            model.insert(0, ("dup", len(ops), entry))
        else:
            ops.append(ast.Push(entry))
            model.insert(0, ("pushed", len(ops), entry))

    # delete the consumed originals (they sit below the result block)
    while any(isinstance(x, tuple) and len(x) == 2 for x in model):
        idx = next(i for i, x in enumerate(model)
                   if isinstance(x, tuple) and len(x) == 2)
        if idx > 0:
            emit_swap(idx)
        ops.append(ast.StandardOp("POP"))
        model.pop(0)

    # repair the result block order with transpositions; model entries are
    # ("dup"/"pushed", seq, entry) markers — compare by payload
    def payload(x):
        return x[2] if isinstance(x, tuple) and len(x) == 3 else x

    for p in range(len(goal) - 1, 0, -1):
        if payload(model[p]) == _key(goal[p]):
            continue
        q = next(i for i in range(p)
                 if payload(model[i]) == _key(goal[p]))
        if q != 0:
            emit_swap(q)
        emit_swap(p)
    assert [payload(x) for x in model] == [_key(g) for g in goal]
    return ops


def _key(entry):
    return entry
