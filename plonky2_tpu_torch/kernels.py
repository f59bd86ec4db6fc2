"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes``.  The build
runs at first use, into ``build/`` beside the package (listed in
``.gitignore``), under a name keyed by the sources' hash, so a changed source
is rebuilt and an unchanged one is reused.  Nothing is built on import.

Every C entry launches on the stream it is given, allocates nothing and
returns ``cudaGetLastError()``; ``call`` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# Each C entry's parameters, named as in csrc/ (tests/test_torch_boundary.py
# holds the two against each other); ``named_args`` reads a launch by name.
SIGNATURES = {
    "plk_hash_leaves": (("in", _P), ("out", _P), ("L", _LL), ("N", _LL),
                        ("device", _I), ("stream", _P)),
    "plk_compress_level": (("in", _P), ("out", _P), ("m", _LL),
                           ("device", _I), ("stream", _P)),
    "plk_compress_tail": (("in", _P), ("out", _P), ("m0", _LL),
                          ("n_levels", _I), ("device", _I), ("stream", _P)),
    "plk_ntt_cols_dit": (("in", _P), ("out", _P), ("twiddles", _P),
                         ("pre", _P), ("post", _P), ("B", _LL),
                         ("log_n1", _I), ("n2", _LL), ("log_t", _I),
                         ("device", _I), ("stream", _P)),
    "plk_ntt_cols_zero_tail": (("in", _P), ("out", _P), ("twiddles", _P),
                               ("factors", _P), ("pre", _P), ("post", _P),
                               ("B", _LL), ("rate_bits", _I), ("log_n1", _I),
                               ("n2", _LL), ("log_t", _I), ("device", _I),
                               ("stream", _P)),
    "plk_ntt_cols_dif": (("in", _P), ("out", _P), ("twiddles", _P),
                         ("factors", _P), ("pre", _P), ("post", _P),
                         ("B", _LL), ("q", _LL), ("log_n1", _I), ("n2", _LL),
                         ("log_t", _I), ("device", _I), ("stream", _P)),
    "plk_ntt_rows_dit": (("in", _P), ("out", _P), ("twiddles", _P),
                         ("post", _P), ("B", _LL), ("log_n1", _I),
                         ("log_n2", _I), ("device", _I), ("stream", _P)),
    "plk_ntt_rows_dif": (("data", _P), ("twiddles", _P), ("B", _LL),
                         ("log_n1", _I), ("log_n2", _I), ("device", _I),
                         ("stream", _P)),
    "plk_constraint_program": (("in", _P), ("out", _P), ("ops", _P),
                               ("n_ops", _I), ("bank", _P),
                               ("bank_size", _I), ("input_slot", _P),
                               ("out_operands", _P),
                               ("n_out", _I), ("n_slots", _I),
                               ("n_shared", _I), ("lanes", _I),
                               ("bank_shared", _I), ("scratch", _P),
                               ("scratch_lanes", _LL),
                               ("C", _LL), ("device", _I), ("stream", _P)),
    "plk_poseidon_wires_waves": (("values", _P), ("dep_idx", _P),
                                 ("out_idx", _P), ("offsets", _P),
                                 ("n_waves", _I), ("R", _LL),
                                 ("max_rows", _LL), ("err", _P),
                                 ("device", _I), ("stream", _P)),
    "plk_pow_grind": (("state", _P), ("inputs", _P), ("n_in", _I),
                      ("pos", _I), ("bits", _I), ("start", _LL),
                      ("limit", _LL), ("scratch", _P), ("out", _P),
                      ("slot", _P), ("device", _I), ("stream", _P)),
    "plk_sponge": (("buf", _P), ("src", _P), ("rows", _I), ("stride", _LL),
                   ("cols", _LL), ("n_in", _I), ("n_out", _I), ("dst", _P),
                   ("n_draws", _I), ("idx", _P), ("index_mask", _LL),
                   ("powers", _P), ("arity", _I), ("device", _I),
                   ("stream", _P)),
}


def named_args(name: str, args) -> dict:
    """The arguments of one call of C entry `name`, by parameter name."""
    params = SIGNATURES[name]
    if len(args) != len(params):
        raise TypeError(f"{name}: {len(args)} arguments, expected "
                        f"{len(params)}")
    return {p: a for (p, _), a in zip(params, args)}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _poseidon_header() -> str:
    """__constant__ tables for csrc/poseidon.cu from the port's constants
    (the .npy and .npz stay the one source of the round constants and of
    the fast partial-round schedule's tables)."""
    from .hash import poseidon as pos

    def table(ctype, name, values, suffix="ull"):
        vals = ", ".join(f"{int(v)}{suffix}" for v in np.ravel(values))
        return (f"__constant__ {ctype} {name}[{np.size(values)}] = "
                f"{{{vals}}};\n")

    return ("#pragma once\n#include <cstdint>\n"
            + table("uint64_t", "PLK_RC", pos.ALL_ROUND_CONSTANTS)
            + table("double", "PLK_MDS_F64", pos.MDS_MATRIX, ".0")
            + table("uint64_t", "PLK_FAST_FIRST",
                    pos.FAST_PARTIAL_FIRST_ROUND_CONSTANT)
            + table("uint64_t", "PLK_FAST_INIT",
                    pos.FAST_PARTIAL_ROUND_INITIAL_MATRIX)
            + table("uint64_t", "PLK_FAST_PRC",
                    pos.fast_round_constants_after_sbox())
            + table("uint64_t", "PLK_FAST_WHAT", pos.FAST_PARTIAL_ROUND_W_HATS)
            + table("uint64_t", "PLK_FAST_VS", pos.FAST_PARTIAL_ROUND_VS)
            + f"constexpr uint64_t PLK_FAST_MS0 = {pos.FAST_MS0}ull;\n")


def _sources(directory: str = CSRC):
    return sorted(glob.glob(os.path.join(directory, "*.cu")))


def _build_key(header: str, directory: str = CSRC) -> str:
    h = hashlib.sha256(header.encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    for d in sorted({CSRC, directory}):
        for path in sorted(glob.glob(os.path.join(d, "*"))):
            if os.path.isfile(path):
                with open(path, "rb") as f:
                    h.update(os.path.basename(path).encode() + f.read())
    return h.hexdigest()[:16]


def _compile(sources, out_dir: str, lib_path: str) -> dict:
    """One nvcc process per source, run in parallel, then one link."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", out_dir, "-I", CSRC, "-c", "-o",
               obj, src]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = f"{lib_path}.{tag}"
    link = subprocess.run([nvcc, "-shared", "-o", tmp,
                           *[obj for _, obj, _ in jobs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                           f"{link.stdout}\n{link.stderr}")
    os.replace(tmp, lib_path)
    for _, obj, _ in jobs:
        os.remove(obj)
    return {"path": lib_path, "seconds": time.perf_counter() - t0,
            "log": "\n".join(logs)}


def build() -> dict:
    """Compile the library if this source tree has not been built yet:
    one nvcc process per source, run in parallel, then one link.
    Returns {"path", "seconds", "log"} (seconds 0.0 when reused)."""
    header = _poseidon_header()
    out_dir = os.path.join(BUILD_ROOT, _build_key(header))
    lib_path = os.path.join(out_dir, "libplonky2_tpu_torch.so")
    if os.path.isfile(lib_path):
        return {"path": lib_path, "seconds": 0.0, "log": ""}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "poseidon_constants.h"), "w") as f:
        f.write(header)
    return _compile(_sources(), out_dir, lib_path)


PROBES = os.path.join(CSRC, "probes")


def build_probes() -> dict:
    """Compile csrc/probes/ (measurement probes for chip_smoke.py, which
    no main path runs) into a library of their own, as ``build`` does."""
    out_dir = os.path.join(BUILD_ROOT, "probes-" + _build_key("", PROBES))
    lib_path = os.path.join(out_dir, "libprobes.so")
    if os.path.isfile(lib_path):
        return {"path": lib_path, "seconds": 0.0, "log": ""}
    return _compile(_sources(PROBES), out_dir, lib_path)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    for name, params in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [t for _, t in params]
        fn.restype = ctypes.c_int
    lib.plk_error_string.argtypes = [ctypes.c_int]
    lib.plk_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, *args) -> None:
    """Launch one C entry and raise on a launch error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.plk_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t) -> int | None:
    """Device pointer of a tensor, or None (a C nullptr) for no tensor."""
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_field_tensor(t, name: str, ndim: int | None = None) -> None:
    """Type checks every wrapper makes before it picks a path."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.int64:
        raise TypeError(f"{name}: expected int64 (u64 bit patterns), "
                        f"got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")


def on_cpu(t: torch.Tensor) -> bool:
    """True when a wrapper takes its plain version: only for CPU tensors.
    Any other device must be CUDA, or the wrapper raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


def check_kernel_operand(t, name: str, device: torch.device,
                         shape=None) -> None:
    """A tensor a kernel reads or writes: int64, contiguous, on `device`,
    of `shape` where given."""
    check_field_tensor(t, name)
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel operands must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
