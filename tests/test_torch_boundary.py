"""The port's boundary: no module of plonky2_tpu_torch, and not chip_smoke.py,
may import jax or plonky2_tpu (the card's machine has no JAX); chip_smoke.py
must fail without a CUDA device and without the rest of the repository."""
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["plonky2_tpu"] = None
import plonky2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(plonky2_tpu_torch.__path__,
                                               "plonky2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib",
       "plonky2_tpu.")) or m == "plonky2_tpu"]
assert all(sys.modules[m] is None for m in bad), bad
print(len(names))
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_without_jax_or_reference_package():
    r = _run(["-c", _IMPORT_ALL], REPO)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 15   # every module of the port was imported


def test_chip_smoke_fails_without_cuda():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_wrappers_launch_with_declared_signatures(monkeypatch):
    """Drive each wrapper's kernel branch with the launch replaced by a
    recorder: the arguments must match the C entry's declared signature and
    the launch count must go up by one per launch."""
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.ops import ntt_cuda as nc

    calls = []
    monkeypatch.setattr(kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: calls.append((name, args)))
    z = torch.zeros
    i64 = torch.int64
    cases = [
        (pc.hash_leaves_cols_cuda, (z((234, 64), dtype=i64),), {}, (4, 64)),
        (pc.compress_level_cuda, (z((4, 64), dtype=i64),), {}, (4, 32)),
        (nc.ntt_cols_cuda, (z((3, 16, 8), dtype=i64), True),
         {"post": z((16, 8), dtype=i64)}, (3, 16, 8)),
        (nc.ntt_cols_dif_cuda, (z((3, 2, 8), dtype=i64), 14),
         {"pre": z((2, 8), dtype=i64), "post": z((16, 8), dtype=i64)},
         (3, 16, 8)),
    ]
    shapes = [{"L": 234, "N": 64}, {"m": 32},
              {"B": 3, "log_n1": 4, "n2": 8, "pre": None},
              {"B": 3, "q": 2, "log_n1": 4, "n2": 8}]
    for (wrapper, args, kwargs, out_shape), shape in zip(cases, shapes):
        before = wrapper.launches
        out = wrapper(*args, **kwargs)
        assert tuple(out.shape) == out_shape
        assert wrapper.launches == before + 1
        name, cargs = calls[-1]
        named = kernels.named_args(name, cargs)
        assert {k: named[k] for k in shape} == shape, name
        assert named["out"] == out.data_ptr()
    assert [c[0] for c in calls] == list(kernels.SIGNATURES)


def test_signatures_match_csrc():
    """kernels.SIGNATURES names and types each C entry's parameters as the
    extern "C" declarations in csrc/ do."""
    import ctypes
    import glob
    import re

    from plonky2_tpu_torch import kernels

    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "long long": ctypes.c_longlong, "int": ctypes.c_int}
    found = {}
    for path in glob.glob(os.path.join(kernels.CSRC, "*.cu")):
        with open(path) as f:
            src = f.read()
        for name, params in re.findall(
                r'extern "C" int (plk_\w+)\(([^)]*)\)', src):
            decl = []
            for param in params.split(","):
                ctype, pname = re.fullmatch(r"\s*(.*?\*?)\s*(\w+)\s*",
                                            param).groups()
                decl.append((pname, c_types[ctype]))
            found[name] = tuple(decl)
    assert found == kernels.SIGNATURES
