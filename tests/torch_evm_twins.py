"""JAX EVM test modules run against the port, each call of the assembler
and of the interpreter made by both packages and compared.

``ported(name)`` loads tests/<name>.py with every ``plonky2_tpu`` import
pointed at ``plonky2_tpu_torch`` and returns the module.  In it:

- ``parse`` records the source of each parsed file;
- ``assemble`` assembles with the port, then assembles the same sources
  with the JAX package and holds the code bytes, code hash, global labels
  and prover-input offsets equal; ``block_kernel`` does so for the block
  kernel;
- ``run_with_kernel`` runs the port's interpreter, then the JAX
  package's on the JAX twin of the kernel from a deep copy of the same
  arguments (so a stateful prover-input provider starts fresh), and holds
  the final stacks, memory, segment memory and gas equal, or both runs
  raising the same kind of exception (a panic).

A test module's own functions and fixtures then run against the port
unchanged, as its JAX original runs in its own file."""
from __future__ import annotations

import copy
import importlib.util
import pathlib
import re
import sys

from plonky2_tpu.evm import block as jblock
from plonky2_tpu.evm import kernel as jkernel
from plonky2_tpu.evm.kernel import interpreter as jinterp
from plonky2_tpu_torch.evm import block as pblock
from plonky2_tpu_torch.evm import kernel as pkernel
from plonky2_tpu_torch.evm.kernel import interpreter as pinterp

TESTS = pathlib.Path(__file__).resolve().parent
_SOURCES = {}           # id of a port-parsed file -> (its source, the file)
_TWINS = {}             # id of a port Kernel -> (the Kernel, its JAX twin)


def parse(src):
    parsed = pkernel.parse(src)
    _SOURCES[id(parsed)] = (src, parsed)
    return parsed


def _jax_parse(parsed):
    entry = _SOURCES.get(id(parsed))
    if entry is None or entry[1] is not parsed:
        raise ValueError("the file was not parsed through the twin parse")
    return jkernel.parse(entry[0])


def kernel_fields(k) -> tuple:
    return (bytes(k.code), [int(x) for x in k.code_hash],
            dict(k.global_labels), dict(k.prover_inputs))


def assemble(files, constants, optimize=True):
    k = pkernel.assemble(files, constants, optimize=optimize)
    jk = jkernel.assemble([_jax_parse(f) for f in files], dict(constants),
                          optimize=optimize)
    assert kernel_fields(k) == kernel_fields(jk)
    _TWINS[id(k)] = (k, jk)
    return k


def block_kernel(in_kernel_ecrecover: bool = True):
    k = pblock.block_kernel(in_kernel_ecrecover=in_kernel_ecrecover)
    jk = jblock.block_kernel(in_kernel_ecrecover=in_kernel_ecrecover)
    assert kernel_fields(k) == kernel_fields(jk)
    _TWINS[id(k)] = (k, jk)
    return k


def twin_of(k):
    entry = _TWINS.get(id(k))
    if entry is None or entry[0] is not k:
        raise ValueError("the kernel was not made by the twin assemble")
    return entry[1]


def state_fields(st) -> tuple:
    return (list(st.stack), bytes(st.memory), dict(st.segmem), st.gas_used)


def run_with_kernel(kernel, initial_offset, initial_stack, **kwargs):
    jargs = copy.deepcopy((list(initial_stack), kwargs))
    try:
        st = pinterp.run_with_kernel(kernel, initial_offset,
                                     initial_stack, **kwargs)
    except Exception as refusal:       # a panic, or a provider's assert
        try:
            jinterp.run_with_kernel(twin_of(kernel), initial_offset,
                                    jargs[0], **jargs[1])
        except Exception as jrefusal:
            if type(jrefusal).__name__ == type(refusal).__name__:
                raise refusal from None
            raise AssertionError(f"the port raised {refusal!r}, the JAX "
                                 f"package {jrefusal!r}") from None
        raise AssertionError(f"the port raised {refusal!r} and the JAX "
                             "package did not") from None
    jst = jinterp.run_with_kernel(twin_of(kernel), initial_offset, jargs[0],
                                  **jargs[1])
    assert state_fields(st) == state_fields(jst)
    return st


_IMPORT = re.compile(r"\bplonky2_tpu\b(?!_torch)")


def ported(name: str):
    """tests/<name>.py with its plonky2_tpu imports pointed at the port
    and the twin parse/assemble/block_kernel/run_with_kernel in its
    namespace."""
    modname = f"tests._ported_{name}"
    if modname in sys.modules:
        return sys.modules[modname]
    source = _IMPORT.sub("plonky2_tpu_torch",
                         (TESTS / f"{name}.py").read_text())
    spec = importlib.util.spec_from_loader(modname, loader=None)
    module = importlib.util.module_from_spec(spec)
    module.__file__ = str(TESTS / f"{name}.py")
    sys.modules[modname] = module
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    for fn in ("parse", "assemble", "block_kernel", "run_with_kernel"):
        if fn in module.__dict__:
            module.__dict__[fn] = globals()[fn]
    return module
