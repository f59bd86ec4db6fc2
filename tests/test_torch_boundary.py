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
    assert int(r.stdout.strip()) >= 42   # every module of the port was imported


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
    from plonky2_tpu_torch.plonk import constraint_program as cp
    from plonky2_tpu_torch.plonk import constraint_program_cuda as cpc

    prog, _ = cp.load(os.path.join(REPO, "plonky2_tpu_torch", "plonk",
                                   "programs", "hash_tree_wide_ecc.npz"))
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
        (nc.ntt_cols_zero_tail_cuda, (z((3, 2, 8), dtype=i64), 3),
         {"pre": z((2, 8), dtype=i64), "post": z((16, 8), dtype=i64)},
         (3, 16, 8)),
        (nc.ntt_cols_dif_cuda, (z((3, 2, 8), dtype=i64), 14),
         {"pre": z((2, 8), dtype=i64), "post": z((16, 8), dtype=i64)},
         (3, 16, 8)),
        (nc.ntt_rows_cuda, (z((3, 16, 8), dtype=i64), True),
         {"post": z((8, 16), dtype=i64)}, (3, 8, 16)),
        (nc.ntt_rows_dif_cuda, (z((3, 16, 8), dtype=i64),), {}, (3, 16, 8)),
        (cpc.run_program_cuda, (prog, z((prog.n_inputs, 64), dtype=i64),
                                z((len(prog.bank_sids),), dtype=i64)), {},
         (2, 64)),
    ]
    shapes = [{"L": 234, "N": 64}, {"m": 32},
              {"B": 3, "log_n1": 4, "n2": 8, "pre": None},
              {"B": 3, "rate_bits": 3, "log_n1": 4, "n2": 8},
              {"B": 3, "q": 2, "log_n1": 4, "n2": 8},
              {"B": 3, "log_n1": 4, "log_n2": 3},
              {"B": 3, "log_n1": 4, "log_n2": 3},
              {"n_ops": 4045, "n_out": 2, "n_slots": 211, "C": 64}]
    for (wrapper, args, kwargs, out_shape), shape in zip(cases, shapes):
        before = wrapper.launches
        out = wrapper(*args, **kwargs)
        assert tuple(out.shape) == out_shape
        assert wrapper.launches == before + 1
        name, cargs = calls[-1]
        named = kernels.named_args(name, cargs)
        assert {k: named[k] for k in shape} == shape, name
        # K5's row form runs in place on its one operand
        assert named.get("out", named.get("data")) == out.data_ptr()
    assert [c[0] for c in calls] == list(kernels.SIGNATURES)
    # the zero-tail forms get their factor table, K5 without a tail none
    assert kernels.named_args(*calls[3])["factors"] is not None
    assert kernels.named_args(*calls[4])["factors"] is not None
    nc.ntt_cols_dif_cuda(z((3, 16, 8), dtype=i64))
    assert kernels.named_args(*calls[-1])["factors"] is None
    a = z((3, 16, 8), dtype=i64)
    assert nc.ntt_rows_dif_cuda(a) is a
    assert kernels.named_args(*calls[-1])["data"] == a.data_ptr()
    # the quotient gathers only the input rows the program reads, and K6
    # reads them where they lie
    before = cpc.run_program_cuda.launches
    rows = z((len(cp.linearize(prog).input_rows), 64), dtype=i64)
    cpc.run_program_cuda(prog, rows, z((857,), dtype=i64))
    assert kernels.named_args(*calls[-1])["in"] == rows.data_ptr()
    assert cpc.run_program_cuda.launches == before + 1


def test_fri_stages_launch_their_kernels(monkeypatch):
    """On a tensor that is not on the CPU, a fold layer's tree goes through
    K1 and K2, a fold's evaluation in leaf order through K5 (both forms)
    and the composition's coset INTT through K3 (both forms); no plain
    version runs."""
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.fri import device_prover as tdp
    from plonky2_tpu_torch.hash import poseidon as pos
    from plonky2_tpu_torch.ops import ntt
    from plonky2_tpu_torch.ops import ntt_cuda as nc

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran")
    for mod, name in ((pos, "hash_leaves_cols"), (pos, "compress_pairs_cols"),
                      (nc, "ntt_cols"), (nc, "ntt_cols_dif"),
                      (nc, "ntt_rows"), (nc, "ntt_rows_dif")):
        monkeypatch.setattr(mod, name, no_plain)
    calls = []
    monkeypatch.setattr(kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: calls.append(name))
    z = lambda *shape: torch.zeros(shape, dtype=torch.int64)  # noqa: E731
    tree = tdp.commit_layer((z(512), z(512)), 16, 2)
    assert tuple(tree.leaves_dev.shape) == (32, 32)
    assert calls == ["plk_hash_leaves"] + ["plk_compress_level"] * 3
    calls.clear()
    assert tuple(ntt.lde_coset_ntt_bitrev(z(2, 32), 0, 49).shape) == (2, 32)
    assert calls == ["plk_ntt_cols_dif", "plk_ntt_rows_dif"]
    calls.clear()
    assert tuple(ntt.coset_intt(z(2, 1 << 11)).shape) == (2, 1 << 11)
    assert calls == ["plk_ntt_cols_dit", "plk_ntt_rows_dit"]


def test_ntt_row_forms_raise_instead_of_falling_back(monkeypatch):
    """A CUDA tensor that a row form cannot take raises before any launch:
    no quiet plain version, no torch transpose."""
    import pytest
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.ops import ntt_cuda as nc

    def no_launch(name, *args):
        raise AssertionError(f"{name} was launched")
    monkeypatch.setattr(kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "call", no_launch)
    long_rows = torch.zeros((1, 2, 2 * nc.MAX_N2_ROWS), dtype=torch.int64)
    for fn in (nc.ntt_rows_cuda, nc.ntt_rows_dif_cuda):
        with pytest.raises(ValueError, match="at most"):
            fn(long_rows)
    a = torch.zeros((2, 8, 12), dtype=torch.int64)
    for fn in (nc.ntt_rows_cuda, nc.ntt_rows_dif_cuda):
        with pytest.raises(ValueError):        # not a power of two
            fn(a)
        with pytest.raises(ValueError):        # not contiguous
            fn(a[:, :, :8])
    with pytest.raises(ValueError):            # post of the wrong shape
        nc.ntt_rows_cuda(a[:, :, :8].contiguous(),
                         post=torch.zeros((4, 8), dtype=torch.int64))


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
