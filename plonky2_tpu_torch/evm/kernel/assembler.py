"""The port's copy of plonky2_tpu/evm/kernel/assembler.py.

Kernel assembler: macro expansion, constant inlining, %stack expansion,
label resolution, bytecode emission and code hashing
(reference evm/src/cpu/kernel/assembler.rs)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...hash.keccak import keccak256
from . import asm_ast as ast
from .opcodes import get_opcode, get_push_opcode
from .optimizer import optimize_asm
from .stack_manipulation import expand_stack_manipulation

# Number of bytes pushed for a code offset (reference assembler.rs:21)
BYTES_PER_OFFSET = 3


@dataclass
class Kernel:
    """(reference assembler.rs:23-79)."""
    code: bytes
    global_labels: Dict[str, int]
    prover_inputs: Dict[int, Tuple[str, ...]] = field(default_factory=dict)

    def __post_init__(self):
        digest = keccak256(self.code)
        self.code_hash = tuple(
            int.from_bytes(digest[4 * i:4 * i + 4], "little")
            for i in range(8))
        self.ordered_labels = sorted(self.global_labels,
                                     key=self.global_labels.get)

    def offset_name(self, offset: int) -> str:
        for label in reversed(self.ordered_labels):
            lo = self.global_labels[label]
            if lo == offset:
                return label
            if lo < offset:
                return f"{offset}, below {label}"
        return str(offset)

    def offset_label(self, offset: int) -> Optional[str]:
        for k, v in self.global_labels.items():
            if v == offset:
                return k
        return None


def u256_to_trimmed_be_bytes(v: int) -> bytes:
    """Minimal big-endian encoding, at least one byte
    (reference kernel/utils.rs)."""
    n = max(1, (v.bit_length() + 7) // 8)
    return v.to_bytes(n, "big")


def assemble(files: List[ast.File], constants: Dict[str, int],
             optimize: bool = True) -> Kernel:
    """(reference assembler.rs:102-137)."""
    macros = _find_macros(files)
    global_labels: Dict[str, int] = {}
    prover_inputs: Dict[int, Tuple[str, ...]] = {}
    offset = 0
    expanded_files = []
    local_labels_per_file = []
    counter = [0]
    for f in files:
        body = _expand_macros(f.body, macros, counter)
        body = _inline_constants(body, constants)
        body = expand_stack_manipulation(body)
        if optimize:
            body = optimize_asm(body)
        locals_, offset = _find_labels(body, offset, global_labels,
                                       prover_inputs)
        expanded_files.append(body)
        local_labels_per_file.append(locals_)

    code = bytearray()
    for body, locals_ in zip(expanded_files, local_labels_per_file):
        _assemble_file(body, code, locals_, global_labels)
    assert len(code) == offset, "Code length doesn't match offset."
    return Kernel(bytes(code), global_labels, prover_inputs)


def _find_macros(files: List[ast.File]) -> Dict[tuple, ast.MacroDef]:
    macros = {}
    for f in files:
        for item in f.body:
            if isinstance(item, ast.MacroDef):
                sig = (item.name, len(item.params))
                assert sig not in macros, f"Duplicate macro signature: {sig}"
                macros[sig] = item
    return macros


def _expand_macros(body: List[ast.Item], macros, counter) -> List[ast.Item]:
    out: List[ast.Item] = []
    for item in body:
        if isinstance(item, ast.MacroDef):
            continue
        if isinstance(item, ast.MacroCall):
            out.extend(_expand_macro_call(item, macros, counter))
        elif isinstance(item, ast.Repeat):
            for _ in range(item.count):
                out.extend(_expand_macros(item.body, macros, counter))
        else:
            out.append(item)
    return out


def _expand_macro_call(call: ast.MacroCall, macros, counter) -> List[ast.Item]:
    sig = (call.name, len(call.args))
    macro = macros.get(sig)
    assert macro is not None, f"No such macro: {sig}"
    tag = counter[0]
    counter[0] += 1

    def actual_label(name: str) -> str:
        return f"@{tag}.{name}"

    def get_arg(var: str) -> ast.PushTarget:
        try:
            idx = macro.params.index(var)
        except ValueError:
            raise AssertionError(
                f"No such param: {var} {macro.params}") from None
        return call.args[idx]

    def subst_target(t):
        if isinstance(t, ast.MacroVar):
            return get_arg(t.name)
        if isinstance(t, ast.MacroLabel):
            return ast.Label(actual_label(t.name))
        return t

    expanded: List[ast.Item] = []
    for item in macro.body:
        if isinstance(item, ast.MacroLabelDeclaration):
            expanded.append(ast.LocalLabelDeclaration(actual_label(item.name)))
        elif isinstance(item, ast.Push):
            expanded.append(ast.Push(subst_target(item.target)))
        elif isinstance(item, ast.MacroCall):
            expanded.append(ast.MacroCall(
                item.name, [subst_target(a) for a in item.args]))
        elif isinstance(item, ast.StackManipulation):
            after = []
            for rep in item.after:
                if isinstance(rep, ast.MacroLabel):
                    after.append(ast.Identifier(actual_label(rep.name)))
                elif isinstance(rep, ast.MacroVar):
                    t = get_arg(rep.name)
                    after.append(ast.Identifier(t.name)
                                 if isinstance(t, ast.Label) else t)
                else:
                    after.append(rep)
            expanded.append(ast.StackManipulation(item.before, after))
        else:
            expanded.append(item)
    return _expand_macros(expanded, macros, counter)


def _inline_constants(body: List[ast.Item],
                      constants: Dict[str, int]) -> List[ast.Item]:
    def resolve(c: str) -> int:
        assert c in constants, f"No such constant: {c}"
        return constants[c]

    out = []
    for item in body:
        if isinstance(item, ast.Push) and isinstance(item.target,
                                                     ast.Constant):
            out.append(ast.Push(ast.Literal(resolve(item.target.name))))
        elif isinstance(item, ast.StackManipulation):
            after = [ast.Literal(resolve(r.name))
                     if isinstance(r, ast.Constant) else r
                     for r in item.after]
            out.append(ast.StackManipulation(item.before, after))
        else:
            out.append(item)
    return out


def _push_target_size(target: ast.PushTarget) -> int:
    if isinstance(target, ast.Literal):
        return len(u256_to_trimmed_be_bytes(target.value))
    if isinstance(target, ast.Label):
        return BYTES_PER_OFFSET
    raise AssertionError(f"Target should have been expanded: {target}")


def _find_labels(body, offset, global_labels, prover_inputs):
    local_labels: Dict[str, int] = {}
    for item in body:
        if isinstance(item, ast.GlobalLabelDeclaration):
            assert item.name not in global_labels, \
                f"Duplicate global label: {item.name}"
            global_labels[item.name] = offset
        elif isinstance(item, ast.LocalLabelDeclaration):
            assert item.name not in local_labels, \
                f"Duplicate local label: {item.name}"
            local_labels[item.name] = offset
        elif isinstance(item, ast.Push):
            offset += 1 + _push_target_size(item.target)
        elif isinstance(item, ast.ProverInput):
            prover_inputs[offset] = item.fn
            offset += 1
        elif isinstance(item, ast.StandardOp):
            offset += 1
        elif isinstance(item, ast.Bytes):
            offset += len(item.data)
        elif isinstance(item, ast.Jumptable):
            offset += len(item.labels) * BYTES_PER_OFFSET
        else:
            raise AssertionError(f"Item should have been expanded: {item}")
    return local_labels, offset


def _look_up_label(label, local_labels, global_labels) -> bytes:
    offset = local_labels.get(label)
    if offset is None:
        offset = global_labels.get(label)
    assert offset is not None, f"No such label: {label}"
    return offset.to_bytes(BYTES_PER_OFFSET, "big")


def _assemble_file(body, code: bytearray, local_labels, global_labels):
    for item in body:
        if isinstance(item, (ast.GlobalLabelDeclaration,
                             ast.LocalLabelDeclaration)):
            continue
        if isinstance(item, ast.Push):
            if isinstance(item.target, ast.Literal):
                tb = u256_to_trimmed_be_bytes(item.target.value)
            elif isinstance(item.target, ast.Label):
                tb = _look_up_label(item.target.name, local_labels,
                                    global_labels)
            else:
                raise AssertionError(f"Unexpanded push target: {item.target}")
            code.append(get_push_opcode(len(tb)))
            code.extend(tb)
        elif isinstance(item, ast.ProverInput):
            code.append(get_opcode("PROVER_INPUT"))
        elif isinstance(item, ast.StandardOp):
            code.append(get_opcode(item.mnemonic))
        elif isinstance(item, ast.Bytes):
            code.extend(item.data)
        elif isinstance(item, ast.Jumptable):
            for label in item.labels:
                code.extend(_look_up_label(label, local_labels,
                                           global_labels))
        else:
            raise AssertionError(f"Item should have been expanded: {item}")
