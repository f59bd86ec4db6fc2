"""The port's copy of plonky2_tpu/evm/kernel/parser.py.

Kernel assembly parser (reference evm/src/cpu/kernel/parser.rs + the
evm_asm.pest grammar it drives).

Hand-rolled recursive descent over a regex token stream; accepts the same
surface syntax: `%macro name(a, b) ... %endmacro`, `%rep N ... %endrep`,
`%stack (a, b: 2) -> (b, 0x20, @CONST, a)`, `GLOBAL lbl:` / `lbl:` /
`%%lbl:`, `PUSH <target>`, `PROVER_INPUT(path::to::fn)`, `BYTES 1, 0x02`,
`JUMPTABLE l1, l2`, bare mnemonics, and `//` and `/* */` comments."""
from __future__ import annotations

import re
from typing import List, Optional

from . import asm_ast as ast
from .opcodes import is_mnemonic

_TOKEN_RE = re.compile(r"""
    (?P<comment>//[^\n]*|/\*.*?\*/)
  | (?P<hex>0[xX][0-9a-fA-F]+)
  | (?P<dec>\d+)
  | (?P<macrolabel>%%[a-zA-Z_][a-zA-Z0-9_.]*)
  | (?P<directive>%[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<var>\$[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<const>@[a-zA-Z_][a-zA-Z0-9_]*)
  | (?P<ident>[a-zA-Z_][a-zA-Z0-9_.@]*)
  | (?P<punct>->|[():,])
  | (?P<ws>\s+)
""", re.VERBOSE | re.DOTALL)


def _tokenize(src: str) -> List[str]:
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise SyntaxError(f"Unexpected character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        tokens.append(m.group())
    return tokens


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    def peek(self, k: int = 0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise SyntaxError("Unexpected end of input")
        self.i += 1
        return t

    def expect(self, t: str) -> None:
        got = self.next()
        if got != t:
            raise SyntaxError(f"Expected {t!r}, got {got!r}")

    # ---- item parsing ----------------------------------------------------

    def parse_items(self, until: Optional[set] = None) -> List[ast.Item]:
        items = []
        while self.peek() is not None and \
                (until is None or self.peek() not in until):
            items.append(self.parse_item())
        return items

    def parse_item(self) -> ast.Item:
        t = self.peek()
        if t == "%macro":
            return self._macro_def()
        if t == "%rep":
            return self._repeat()
        if t == "%stack":
            return self._stack()
        if t.startswith("%%"):
            name = self.next()[2:]
            self.expect(":")
            return ast.MacroLabelDeclaration(name)
        if t.startswith("%"):
            return self._macro_call()
        if t == "GLOBAL":
            self.next()
            name = self.next()
            self.expect(":")
            return ast.GlobalLabelDeclaration(name)
        if t.upper() == "BYTES" and self.peek(1) not in (":",):
            self.next()
            return ast.Bytes(self._literal_list())
        if t.upper() == "JUMPTABLE":
            self.next()
            return ast.Jumptable(self._ident_list())
        if t.upper() == "PUSH":
            self.next()
            return ast.Push(self._push_target())
        if t.upper() == "PROVER_INPUT":
            self.next()
            self.expect("(")
            parts = [self.next()]
            while self.peek() == ":":
                self.expect(":")
                self.expect(":")
                parts.append(self.next())
            self.expect(")")
            return ast.ProverInput(tuple(parts))
        if self.peek(1) == ":" and not is_mnemonic(t):
            name = self.next()
            self.expect(":")
            return ast.LocalLabelDeclaration(name)
        if is_mnemonic(t):
            return ast.StandardOp(self.next().upper())
        raise SyntaxError(f"Unexpected token {t!r}")

    def _macro_def(self) -> ast.MacroDef:
        self.expect("%macro")
        name = self.next()
        params: List[str] = []
        if self.peek() == "(":
            self.next()
            while self.peek() != ")":
                params.append(self.next())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
        body = self.parse_items(until={"%endmacro"})
        self.expect("%endmacro")
        return ast.MacroDef(name, params, body)

    def _repeat(self) -> ast.Repeat:
        self.expect("%rep")
        count = self._literal_value(self.next())
        body = self.parse_items(until={"%endrep"})
        self.expect("%endrep")
        return ast.Repeat(count, body)

    def _macro_call(self) -> ast.MacroCall:
        name = self.next()[1:]
        args: List[ast.PushTarget] = []
        if self.peek() == "(":
            self.next()
            while self.peek() != ")":
                args.append(self._push_target())
                if self.peek() == ",":
                    self.next()
            self.expect(")")
        return ast.MacroCall(name, args)

    def _stack(self) -> ast.StackManipulation:
        self.expect("%stack")
        self.expect("(")
        before: List[ast.StackPlaceholder] = []
        while self.peek() != ")":
            name = self.next()
            size = 1
            if self.peek() == ":":
                self.next()
                size = self._literal_value(self.next())
            before.append(ast.StackPlaceholder(name, size))
            if self.peek() == ",":
                self.next()
        self.expect(")")
        self.expect("->")
        self.expect("(")
        after: List[ast.StackReplacement] = []
        while self.peek() != ")":
            after.append(self._stack_replacement())
            if self.peek() == ",":
                self.next()
        self.expect(")")
        return ast.StackManipulation(before, after)

    def _stack_replacement(self) -> ast.StackReplacement:
        t = self.peek()
        if t.startswith("%%"):
            return ast.MacroLabel(self.next()[2:])
        if t.startswith("$"):
            return ast.MacroVar(self.next()[1:])
        if t.startswith("@"):
            return ast.Constant(self.next()[1:])
        if re.fullmatch(r"0[xX][0-9a-fA-F]+|\d+", t):
            return ast.Literal(self._literal_value(self.next()))
        return ast.Identifier(self.next())

    def _push_target(self) -> ast.PushTarget:
        t = self.peek()
        if t.startswith("%%"):
            return ast.MacroLabel(self.next()[2:])
        if t.startswith("$"):
            return ast.MacroVar(self.next()[1:])
        if t.startswith("@"):
            return ast.Constant(self.next()[1:])
        if re.fullmatch(r"0[xX][0-9a-fA-F]+|\d+", t):
            return ast.Literal(self._literal_value(self.next()))
        return ast.Label(self.next())

    @staticmethod
    def _literal_value(tok: str) -> int:
        if tok.lower().startswith("0x"):
            return int(tok, 16)
        if tok.isdigit():
            return int(tok)
        raise SyntaxError(f"Expected literal, got {tok!r}")

    def _literal_list(self) -> List[int]:
        out = [self._literal_value(self.next())]
        while self.peek() == ",":
            self.next()
            out.append(self._literal_value(self.next()))
        return out

    def _ident_list(self) -> List[str]:
        out = [self.next()]
        while self.peek() == ",":
            self.next()
            out.append(self.next())
        return out


def parse(source: str) -> ast.File:
    p = _Parser(_tokenize(source))
    body = p.parse_items()
    return ast.File(body)
