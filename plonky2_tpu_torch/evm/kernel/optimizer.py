"""The port's copy of plonky2_tpu/evm/kernel/optimizer.py.

Peephole optimizer for expanded kernel assembly
(reference evm/src/cpu/kernel/optimizer.rs)."""
from __future__ import annotations

from typing import Callable, List, Optional

from . import asm_ast as ast

U256_MASK = (1 << 256) - 1
MAX_ROUNDS = 10  # reference optimizer.rs:12-21 iterates to a fixed point


def optimize_asm(code: List[ast.Item]) -> List[ast.Item]:
    for _ in range(MAX_ROUNDS):
        before = list(code)
        code = _constant_propagation(code)
        code = _identity_operations(code)
        code = _no_op_jumps(code)
        code = _remove_swapped_pushes(code)
        code = _remove_swaps_commutative(code)
        code = _remove_ignored_values(code)
        if code == before:
            break
    return code


def _replace_windows(code: List[ast.Item], width: int,
                     f: Callable[[List[ast.Item]], Optional[List[ast.Item]]]
                     ) -> List[ast.Item]:
    i = 0
    code = list(code)
    while i + width <= len(code):
        rep = f(code[i:i + width])
        if rep is not None:
            code[i:i + width] = rep
            i = max(0, i - width)
        else:
            i += 1
    return code


def _lit(item) -> Optional[int]:
    if isinstance(item, ast.Push) and isinstance(item.target, ast.Literal):
        return item.target.value
    return None


def _push(v: int) -> ast.Item:
    return ast.Push(ast.Literal(v & U256_MASK))


def _constant_propagation(code):
    def unary(w):
        x = _lit(w[0])
        if x is None or not isinstance(w[1], ast.StandardOp):
            return None
        op = w[1].mnemonic
        if op == "ISZERO":
            return [_push(int(x == 0))]
        if op == "NOT":
            return [_push(~x)]
        return None

    code = _replace_windows(code, 2, unary)

    def binary(w):
        y, x = _lit(w[0]), _lit(w[1])
        if x is None or y is None or not isinstance(w[2], ast.StandardOp):
            return None
        op = w[2].mnemonic
        table = {
            "ADD": lambda: x + y, "SUB": lambda: x - y, "MUL": lambda: x * y,
            "DIV": lambda: x // y if y else 0,
            "MOD": lambda: x % y if y else 0,
            "EXP": lambda: pow(x, y, 1 << 256),
            "SHL": lambda: y << x if x < 256 else 0,
            "SHR": lambda: y >> x if x < 256 else 0,
            "AND": lambda: x & y, "OR": lambda: x | y, "XOR": lambda: x ^ y,
            "LT": lambda: int(x < y), "GT": lambda: int(x > y),
            "EQ": lambda: int(x == y),
            "BYTE": lambda: (y >> (8 * (31 - x))) & 0xFF if x < 32 else 0,
        }
        if op not in table:
            return None
        return [_push(table[op]())]

    return _replace_windows(code, 3, binary)


def _identity_operations(code):
    def f(w):
        x = _lit(w[0])
        if x is None or not isinstance(w[1], ast.StandardOp):
            return None
        op = w[1].mnemonic
        if (op == "ADD" and x == 0) or (op == "MUL" and x == 1) or \
                (op in ("OR", "XOR") and x == 0):
            return []
        return None

    return _replace_windows(code, 2, f)


def _no_op_jumps(code):
    def f(w):
        push, jump, decl = w
        if not (isinstance(push, ast.Push)
                and isinstance(push.target, ast.Label)
                and isinstance(jump, ast.StandardOp)
                and jump.mnemonic == "JUMP"):
            return None
        label = push.target.name
        if isinstance(decl, (ast.LocalLabelDeclaration,
                             ast.GlobalLabelDeclaration)) \
                and decl.name == label:
            return [decl]
        return None

    return _replace_windows(code, 3, f)


def _remove_swapped_pushes(code):
    def f(w):
        a, b, swap = w
        if isinstance(a, ast.Push) and isinstance(b, ast.Push) and \
                isinstance(swap, ast.StandardOp) and swap.mnemonic == "SWAP1":
            return [b, a]
        return None

    return _replace_windows(code, 3, f)


def _remove_swaps_commutative(code):
    def f(w):
        swap, op = w
        if isinstance(swap, ast.StandardOp) and swap.mnemonic == "SWAP1" \
                and isinstance(op, ast.StandardOp) \
                and op.mnemonic in ("ADD", "MUL", "AND", "OR", "XOR", "EQ"):
            return [op]
        return None

    return _replace_windows(code, 2, f)


def _remove_ignored_values(code):
    def f(w):
        a, pop = w
        if not (isinstance(pop, ast.StandardOp) and pop.mnemonic == "POP"):
            return None
        if isinstance(a, ast.Push):
            return []
        if isinstance(a, ast.StandardOp) and a.mnemonic.startswith("DUP"):
            return []
        return None

    return _replace_windows(code, 2, f)
