"""The port's boundary: no module of plonky2_tpu_torch, and not chip_smoke.py,
may import jax or plonky2_tpu (the card's machine has no JAX); chip_smoke.py
must fail without a CUDA device and without the rest of the repository."""
import os
import shutil
import subprocess
import sys

import pytest

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
    assert int(r.stdout.strip()) >= 66   # every module of the port was imported


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
        (pc.compress_tail_cuda, (z((4, 64), dtype=i64), 3), {},
         [(4, 32), (4, 16), (4, 8)]),
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
    shapes = [{"L": 234, "N": 64}, {"m": 32}, {"m0": 32, "n_levels": 3},
              {"B": 3, "log_n1": 4, "n2": 8, "pre": None},
              {"B": 3, "rate_bits": 3, "log_n1": 4, "n2": 8},
              {"B": 3, "q": 2, "log_n1": 4, "n2": 8},
              {"B": 3, "log_n1": 4, "log_n2": 3},
              {"B": 3, "log_n1": 4, "log_n2": 3},
              {"n_ops": 4045, "n_out": 2, "n_slots": 211, "C": 64}]
    for (wrapper, args, kwargs, out_shape), shape in zip(cases, shapes):
        before = wrapper.launches
        out = wrapper(*args, **kwargs)
        if isinstance(out, list):
            # K2's narrow top: its levels are consecutive views of the
            # buffer the kernel writes
            assert [tuple(o.shape) for o in out] == out_shape
            for a, b in zip(out, out[1:]):
                assert b.data_ptr() == a.data_ptr() + 8 * a.numel()
            out = out[0]
        else:
            assert tuple(out.shape) == out_shape
        assert wrapper.launches == before + 1
        name, cargs = calls[-1]
        named = kernels.named_args(name, cargs)
        assert {k: named[k] for k in shape} == shape, name
        # K5's row form runs in place on its one operand
        assert named.get("out", named.get("data")) == out.data_ptr()
    # K7 writes a run of waves in place, through its index arrays; the
    # offsets go up once per run and device
    values = z((300,), dtype=i64)
    dep = torch.zeros((13, 7), dtype=torch.int32)
    out = torch.arange(122 * 7, dtype=torch.int32).reshape(122, 7) % 300
    err = torch.zeros(1, dtype=torch.int32)
    before = pc.poseidon_wires_waves_cuda.launches
    assert pc.poseidon_wires_waves_cuda(values, dep, out, (0, 4, 6, 7),
                                        err) is None
    assert pc.poseidon_wires_waves_cuda.launches == before + 1
    named = kernels.named_args(*calls[-1])
    offsets = pc._offsets_on((0, 4, 6, 7), values.device)
    assert offsets.tolist() == [0, 4, 6, 7]
    assert {k: named[k] for k in ("values", "dep_idx", "out_idx", "offsets",
                                  "n_waves", "R", "max_rows", "err")} == {
        "values": values.data_ptr(), "dep_idx": dep.data_ptr(),
        "out_idx": out.data_ptr(), "offsets": offsets.data_ptr(),
        "n_waves": 3, "R": 7, "max_rows": 4, "err": err.data_ptr()}
    # K8 grinds from the 12 words (no inputs pending) into an answer that
    # starts at 2^64 - 1; the recorder writes no answer, so the wrapper
    # finds none
    base = z((12,), dtype=i64)
    before = pc.pow_grind_cuda.launches
    with pytest.raises(RuntimeError, match="no witness"):
        pc.pow_grind_cuda(base, 5, 16, 3, 1 << 20)
    assert pc.pow_grind_cuda.launches == before + 1
    named = kernels.named_args(*calls[-1])
    assert {k: named[k] for k in ("state", "n_in", "pos", "bits", "start",
                                  "limit", "slot")} == {
        "state": base.data_ptr(), "n_in": 0, "pos": 5, "bits": 16,
        "start": 3, "limit": 1 << 20, "slot": None}
    # K9 reads a cap (4, 16) digest by digest and writes two draws and
    # beta's 16 powers behind them
    buf = z((pc.SPONGE_WORDS,), dtype=i64)
    cap = z((4, 16), dtype=i64)
    before = pc.sponge_cuda.launches
    draws, idx, powers = pc.sponge_cuda(buf, 3, 0, cap, 2, 0, 16)
    assert pc.sponge_cuda.launches == before + 1
    assert tuple(draws.shape) == (2,) and idx is None
    assert tuple(powers.shape) == (2, 16)
    named = kernels.named_args(*calls[-1])
    assert {k: named[k] for k in ("buf", "src", "rows", "stride", "cols",
                                  "n_in", "n_out", "dst", "n_draws", "idx",
                                  "index_mask", "powers", "arity")} == {
        "buf": buf.data_ptr(), "src": cap.data_ptr(), "rows": 4,
        "stride": 16, "cols": 16, "n_in": 3, "n_out": 0,
        "dst": draws.data_ptr(), "n_draws": 2, "idx": None,
        "index_mask": 0, "powers": powers.data_ptr(), "arity": 16}
    assert [c[0] for c in calls] == list(kernels.SIGNATURES)
    # K8 on K9's buffer: the state, the pending inputs behind it, the
    # candidate and the answer at pending slot n_in
    before = pc.pow_grind_sponge_cuda.launches
    out = pc.pow_grind_sponge_cuda(buf, 6, 16)
    assert pc.pow_grind_sponge_cuda.launches == before + 1
    assert tuple(out.shape) == (1,)
    named = kernels.named_args(*calls[-1])
    assert {k: named[k] for k in ("state", "inputs", "n_in", "pos", "out",
                                  "slot")} == {
        "state": buf.data_ptr(), "inputs": buf.data_ptr() + 8 * 12,
        "n_in": 6, "pos": 6, "out": out.data_ptr(),
        "slot": buf.data_ptr() + 8 * 18}
    # the zero-tail forms get their factor table, K5 without a tail none
    assert kernels.named_args(*calls[4])["factors"] is not None
    assert kernels.named_args(*calls[5])["factors"] is not None
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
    K1 and K2 (its three levels in one launch), a fold's evaluation in leaf order through K5 (both forms)
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
    assert calls == ["plk_hash_leaves", "plk_compress_tail"]
    calls.clear()
    assert tuple(ntt.lde_coset_ntt_bitrev(z(2, 32), 0, 49).shape) == (2, 32)
    assert calls == ["plk_ntt_cols_dif", "plk_ntt_rows_dif"]
    calls.clear()
    assert tuple(ntt.coset_intt(z(2, 1 << 11)).shape) == (2, 1 << 11)
    assert calls == ["plk_ntt_cols_dit", "plk_ntt_rows_dit"]


@pytest.mark.parametrize("L,n,cap,tail_parents,want", [
    (12, 64, 2, None, ["plk_hash_leaves", "plk_compress_tail"]),
    (12, 64, 0, 4, ["plk_hash_leaves"] + ["plk_compress_level"] * 3
     + ["plk_compress_tail"]),
    (4, 64, 3, 8, ["plk_compress_level"] * 2 + ["plk_compress_tail"]),
    (4, 64, 4, 8, ["plk_compress_level"] * 2),
    (12, 64, 6, None, ["plk_hash_leaves"]),
])
def test_digest_levels_launch_wide_levels_then_one_tail(
        monkeypatch, L, n, cap, tail_parents, want):
    """On a tensor that is not on the CPU, build_digest_levels launches K2
    once for each level of more than TAIL_PARENTS parents, then once for
    all the levels above them; no plain version runs."""
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.hash import merkle_torch
    from plonky2_tpu_torch.hash import poseidon as pos
    from plonky2_tpu_torch.hash import poseidon_cuda as pc

    def no_plain(*args, **kwargs):
        raise AssertionError("a plain version ran")
    for mod, name in ((pos, "hash_leaves_cols"), (pos, "compress_pairs_cols"),
                      (pc, "compress_level"), (pc, "compress_tail")):
        monkeypatch.setattr(mod, name, no_plain)
    calls = []
    monkeypatch.setattr(kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "call",
                        lambda name, *args: calls.append((name, args)))
    if tail_parents is not None:
        monkeypatch.setattr(merkle_torch, "TAIL_PARENTS", tail_parents)
    levels = merkle_torch.build_digest_levels(
        torch.zeros((L, n), dtype=torch.int64), cap)
    assert [c[0] for c in calls] == want
    assert [tuple(x.shape) for x in levels] == [
        (4, n >> k) for k in range(n.bit_length() - cap)]
    if want[-1] == "plk_compress_tail":
        a = kernels.named_args(*calls[-1])
        assert a["m0"] == min(n >> (len(want) - (L > 4)),
                              merkle_torch.TAIL_PARENTS)
        assert a["m0"] >> (a["n_levels"] - 1) == 1 << cap
        assert a["out"] == levels[len(levels) - a["n_levels"]].data_ptr()


def test_refused_tail_launch_raises(monkeypatch):
    """A launch error of the narrow-top kernel (a cooperative launch the
    card refuses) raises; the launch is not counted and nothing runs in its
    place."""
    import pytest
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.hash import poseidon_cuda as pc

    class Refusing:
        @staticmethod
        def plk_compress_tail(*args):
            return 82

        @staticmethod
        def plk_error_string(rc):
            return b"too many blocks in cooperative launch"

    monkeypatch.setattr(kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "library", lambda: Refusing)
    monkeypatch.setattr(pc, "compress_tail", lambda *a: pytest.fail(
        "the plain version ran"))
    before = pc.compress_tail_cuda.launches
    with pytest.raises(RuntimeError, match="cooperative"):
        pc.compress_tail_cuda(torch.zeros((4, 64), dtype=torch.int64), 2)
    assert pc.compress_tail_cuda.launches == before


def test_failed_poseidon_wires_launch_raises(monkeypatch):
    """A launch error of K7 (a refused cooperative launch among them)
    raises: the launch is not counted, the plain version does not run,
    and the slot buffer is not written.  Operands the kernel cannot take
    raise before any launch."""
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.hash import poseidon_wires as pw

    class Failing:
        @staticmethod
        def plk_poseidon_wires_waves(*args):
            return 720

        @staticmethod
        def plk_error_string(rc):
            return b"too many blocks in cooperative launch"

    monkeypatch.setattr(kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "library", lambda: Failing)
    monkeypatch.setattr(pw, "poseidon_wires_waves", lambda *a: pytest.fail(
        "the plain version ran"))
    monkeypatch.setattr(pw, "poseidon_wires", lambda *a: pytest.fail(
        "the plain version ran"))
    values = torch.arange(300, dtype=torch.int64)
    dep = torch.zeros((13, 4), dtype=torch.int32)
    out = torch.arange(122 * 4, dtype=torch.int32).reshape(122, 4) % 300
    err = torch.zeros(1, dtype=torch.int32)
    before = pc.poseidon_wires_waves_cuda.launches
    with pytest.raises(RuntimeError, match="cooperative"):
        pc.poseidon_wires_waves_cuda(values, dep, out, (0, 3, 4), err)
    assert pc.poseidon_wires_waves_cuda.launches == before
    assert torch.equal(values, torch.arange(300, dtype=torch.int64))
    for bad in ((values, dep.long(), out, (0, 4), err),
                (values, dep, out[:, :3], (0, 4), err),
                (values, dep, out, (0, 4), err.long()),
                (values, dep.t().contiguous().t(), out, (0, 4), err),
                (values, dep, out, (0, 5), err),
                (values, dep, out, (3, 2, 4), err)):
        with pytest.raises((TypeError, ValueError)):
            pc.poseidon_wires_waves_cuda(*bad)
    assert pc.poseidon_wires_waves_cuda.launches == before


def test_failed_pow_grind_launch_raises(monkeypatch):
    """A launch error of K8 raises: not counted, no plain grind."""
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.hash import poseidon_cuda as pc

    class Failing:
        @staticmethod
        def plk_pow_grind(*args):
            return 98

        @staticmethod
        def plk_error_string(rc):
            return b"invalid device function"

    monkeypatch.setattr(kernels, "on_cpu", lambda t: False)
    monkeypatch.setattr(kernels, "stream_of", lambda t: 0)
    monkeypatch.setattr(kernels, "library", lambda: Failing)
    monkeypatch.setattr(pc, "pow_grind", lambda *a: pytest.fail(
        "the plain version ran"))
    before = pc.pow_grind_cuda.launches
    with pytest.raises(RuntimeError, match="invalid device function"):
        pc.pow_grind_cuda(torch.zeros(12, dtype=torch.int64), 0, 16)
    assert pc.pow_grind_cuda.launches == before


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
