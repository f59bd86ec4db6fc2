"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

The main path is the flagship wires commitment: PolynomialBatch.from_values
on 234 polynomials of 2^18 values at rate_bits 3, cap height 4, no blinding
(IFFT -> coset LDE in leaf order -> Poseidon leaf hash -> Merkle levels),
then 28 query openings from the device-resident tree.  The script builds the
kernels from csrc/ with nvcc, holds each kernel against its plain PyTorch
version on the card (exact equality: integer arithmetic, tolerance 0), runs
the main path at full width, holds the full-width result against the plain
versions on subsets, verifies the openings, and prints one JSON line with
each kernel's launches, time and bound.  Every phase prints a flushed line
before it starts and when it ends; any failure raises and exits non-zero.
The last line of standard output is the run's device summary.

It imports nothing of JAX or of the JAX package, needs one card, and writes
nothing outside the kernels' build directory.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

T0 = time.perf_counter()

# Main path: the wires commitment of the hash-tree circuit under
# CircuitConfig.wide_ecc_config() (234 wires, 2^18 rows, rate 3, cap 4).
NUM_POLYS = 234
LOG_N = 18
RATE_BITS = 3
CAP_HEIGHT = 4
NUM_QUERIES = 28
WARM_RUNS = 3
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet; CUDA C Programming Guide,
# arithmetic instruction throughput for compute capability 9.0: 64 32-bit
# integer multiply-adds per clock per SM; 132 SMs at the 1.98 GHz boost
# clock).  Both assume the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_S = 132 * 64 * 1.98e9

# 32-bit multiplies one Poseidon permutation needs, counted on the fast
# partial-round schedule (plonky2's mds_partial_layer_init/_fast), the
# cheapest known for this function: 8 full rounds of 12 x^7 S-boxes and the
# dense 12x12 MDS, whose small coefficients take one product per 32-bit half
# of a word (144 x 2); one dense 11x11 layer of full field constants before
# the partial rounds; 22 partial rounds of one S-box and a sparse layer (22
# products by full field constants, one by a small one).  An x^7 S-box is
# four 64x64 products; a 64x64 product is four 32x32->64 products.
#
# Each 32x32->64 product counts as one result of the throughput table's row
# "32-bit integer multiply, multiply-add, extended-precision multiply-add"
# (one IMAD.WIDE.U32 instruction).  That is the fewest instructions the
# products can take, so the bound stays a floor; if the wide form issues at
# half that rate, the floor is twice as high.
FIELD_MUL_MULS = 4   # one 64x64 -> 128 product
_SBOX_MULS = 4 * FIELD_MUL_MULS
_MDS_MULS = 144 * 2
PERM_MULS = (8 * (12 * _SBOX_MULS + _MDS_MULS) + 11 * 11 * FIELD_MUL_MULS
             + 22 * (_SBOX_MULS + 22 * FIELD_MUL_MULS + 2))

KERNELS = {
    # C entry -> (name, source, TPU kernel it replaces)
    "plk_hash_leaves": ("K1 hash_leaves_cols", "plonky2_tpu_torch/csrc/poseidon.cu",
                        "plonky2_tpu/hash/poseidon_pallas.py:401"),
    "plk_compress_level": ("K2 compress_level", "plonky2_tpu_torch/csrc/poseidon.cu",
                           "plonky2_tpu/hash/poseidon_pallas.py:473"),
    "plk_ntt_cols_dit": ("K3 ntt_cols", "plonky2_tpu_torch/csrc/ntt.cu",
                         "plonky2_tpu/ops/ntt_pallas.py:95"),
    "plk_ntt_cols_dif": ("K5 ntt_cols_dif", "plonky2_tpu_torch/csrc/ntt.cu",
                         "plonky2_tpu/ops/ntt_pallas.py:243"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke {time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


class phase:
    """Prints a line when a phase starts and when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        state = "done" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"phase {self.name}: {state} in "
            f"{time.perf_counter() - self.t:.1f} s")
        return False


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rand_field(rng, shape, dev):
    """Canonical field elements drawn by numpy, as an int64 tensor."""
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    return from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), dev)


BOUNDARY = [0, 1, (1 << 32) - 1, 1 << 32, (1 << 64) - (1 << 32)]  # p - 1 last


def boundary_field(rng, shape, dev):
    from plonky2_tpu_torch.field.convert import from_u64
    vals = np.array(BOUNDARY, dtype=np.uint64)
    return from_u64(vals[rng.integers(0, len(vals), size=shape)], dev)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the u64 values of two int64 tensors."""
    from plonky2_tpu_torch.field.convert import to_u64
    x, y = to_u64(a).reshape(-1), to_u64(b).reshape(-1)
    check(x.shape == y.shape, f"shapes {a.shape} vs {b.shape}")
    d = np.maximum(x, y) - np.minimum(x, y)
    return int(d.max()) if d.size else 0


def cuda_ms(fn, warmup: bool = True):
    """Milliseconds of one fn() on the card (CUDA events), after one
    untimed warm-up call when asked."""
    import torch
    if warmup:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


class KernelRecorder:
    """Wraps kernels.call to time every launch with CUDA events and keep
    its arguments (for the bound), without touching the launch counts."""

    def __init__(self):
        from plonky2_tpu_torch import kernels
        self.kernels = kernels
        self.orig = kernels.call
        self.records = []

    def __enter__(self):
        import torch

        def timed(name, *args):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            self.orig(name, *args)
            e.record()
            self.records.append((name, args, s, e))
        self.kernels.call = timed
        return self

    def __exit__(self, *exc):
        self.kernels.call = self.orig
        return False

    def ms_by_kernel(self) -> dict:
        import torch
        torch.cuda.synchronize()
        out = {}
        for name, _, s, e in self.records:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


def launch_cost(name: str, args) -> tuple:
    """(bytes, int32 multiplies) that one launch's work needs at least:
    each input read once, each output written once."""
    from plonky2_tpu_torch.kernels import named_args
    a = named_args(name, args)
    if name == "plk_hash_leaves":
        L, N = a["L"], a["N"]
        perms = N * -(-L // 8)
        return 8 * (L * N + 4 * N), perms * PERM_MULS
    if name == "plk_compress_level":
        m = a["m"]
        return 8 * (8 * m + 4 * m), m * PERM_MULS
    B, n2, log_n1 = a["B"], a["n2"], a["log_n1"]
    n1 = 1 << log_n1
    q = a.get("q", n1)
    pre, post = a["pre"] is not None, a["post"] is not None
    nbytes = 8 * (B * q * n2 + B * n1 * n2 + n1
                  + (q * n2 if pre else 0) + (n1 * n2 if post else 0))
    muls = B * (n1 // 2) * n2 * log_n1 + B * n2 * ((q if pre else 0)
                                                   + (n1 if post else 0))
    return nbytes, muls * FIELD_MUL_MULS


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_device(dev):
    import torch
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log(f"device {torch.cuda.get_device_name(dev)}; torch {torch.__version__}; "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    return smi


def phase_build() -> float:
    from plonky2_tpu_torch import kernels
    info = kernels.build()
    kernels.library()
    for line in info["log"].splitlines():
        if "registers" in line or "bytes stack" in line or "Compiling" in line:
            log("ptxas: " + line.strip())
    log(f"nvcc seconds: {info['seconds']:.1f} ({info['path']})")
    return info["seconds"]


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at reduced shapes, exactly.
    Returns per kernel: max_abs_err, and kernel/plain ms at one shape."""
    from plonky2_tpu_torch.hash import poseidon as pos
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.ops import ntt_cuda as nc
    rng = np.random.default_rng(SEED + 1)
    res = {}

    def compare(entry, label, kernel_fn, plain_fn, timed=False):
        k_ms, got = cuda_ms(kernel_fn)
        p_ms, want = cuda_ms(plain_fn, warmup=False)
        err = max_abs_err(got, want)
        log(f"  {KERNELS[entry][0]} {label}: max_abs_err {err} "
            f"(kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms)")
        check(err == 0, f"{entry} {label} differs from its plain version")
        r = res.setdefault(entry, {"max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if timed:
            r.update(kernel_ms_at_plain_shape=k_ms, plain_ms=p_ms,
                     plain_shape=label)

    for L in (234, 2481):
        leaves = rand_field(rng, (L, 1 << 14), dev)
        compare("plk_hash_leaves", f"L={L} N=2^14",
                lambda: pc.hash_leaves_cols_cuda(leaves),
                lambda: pos.hash_leaves_cols(leaves), timed=L == 234)
    for label, level in (("m=2^14 digests", rand_field(rng, (4, 1 << 15), dev)),
                         ("m=2^14 boundary", boundary_field(rng, (4, 1 << 15), dev))):
        compare("plk_compress_level", label,
                lambda: pc.compress_level_cuda(level),
                lambda: pc.compress_level(level), timed="digests" in label)
    for n1 in (512, 1024, 2048):
        a = rand_field(rng, (4, n1, 512), dev)
        pre = rand_field(rng, (n1, 512), dev)
        post = rand_field(rng, (n1, 512), dev)
        for inverse in (False, True):
            compare("plk_ntt_cols_dit", f"B=4 n1={n1} n2=512 inverse={inverse}",
                    lambda: nc.ntt_cols_cuda(a, inverse),
                    lambda: nc.ntt_cols(a, inverse),
                    timed=n1 == 512 and not inverse)
        compare("plk_ntt_cols_dit", f"B=4 n1={n1} n2=512 pre+post",
                lambda: nc.ntt_cols_cuda(a, True, pre, post),
                lambda: nc.ntt_cols(a, True, pre, post))
    for n1, tail in ((1024, 896), (1024, 0), (2048, 0)):
        q = n1 - tail
        a = rand_field(rng, (4, q, 512), dev)
        pre = rand_field(rng, (q, 512), dev)
        post = rand_field(rng, (n1, 512), dev)
        compare("plk_ntt_cols_dif", f"B=4 n1={n1} tail={tail} n2=512",
                lambda: nc.ntt_cols_dif_cuda(a, tail),
                lambda: nc.ntt_cols_dif(a, tail), timed=n1 == 1024 and tail)
        compare("plk_ntt_cols_dif", f"B=4 n1={n1} tail={tail} n2=512 pre+post",
                lambda: nc.ntt_cols_dif_cuda(a, tail, pre=pre, post=post),
                lambda: nc.ntt_cols_dif(a, tail, pre=pre, post=post))
    return res


def reset_launch_counts():
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.ops import ntt_cuda as nc
    for w in (pc.hash_leaves_cols_cuda, pc.compress_level_cuda,
              nc.ntt_cols_cuda, nc.ntt_cols_dif_cuda):
        w.launches = 0


def read_launch_counts() -> dict:
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.ops import ntt_cuda as nc
    return {"plk_hash_leaves": pc.hash_leaves_cols_cuda.launches,
            "plk_compress_level": pc.compress_level_cuda.launches,
            "plk_ntt_cols_dit": nc.ntt_cols_cuda.launches,
            "plk_ntt_cols_dif": nc.ntt_cols_dif_cuda.launches}


def phase_full_width(dev, rng):
    """The main path at full width: one cold run (counted), WARM_RUNS warm
    runs (timed per kernel), then the result against the plain versions on
    subsets."""
    import torch
    from plonky2_tpu_torch.fri.oracle import PolynomialBatch
    n = 1 << LOG_N
    values = rand_field(rng, (NUM_POLYS, n), dev)
    commit = lambda: PolynomialBatch.from_values(  # noqa: E731
        values, RATE_BITS, False, CAP_HEIGHT, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    t = time.perf_counter()
    batch = commit()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  cold run {cold_s:.3f} s; launches {launches}; peak "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    for entry, count in launches.items():
        check(count > 0, f"{entry} was not launched on the main path")

    warm_s, per_kernel, recs = [], [], None
    for _ in range(WARM_RUNS):
        del batch
        with KernelRecorder() as rec:
            t = time.perf_counter()
            batch = commit()
            torch.cuda.synchronize()
            warm_s.append(time.perf_counter() - t)
        per_kernel.append(rec.ms_by_kernel())
        recs = rec.records
    log(f"  warm runs (s): {', '.join(f'{s:.4f}' for s in warm_s)}")
    kernel_ms = {k: float(np.median([r[k] for r in per_kernel]))
                 for k in per_kernel[0]}
    for k, ms in kernel_ms.items():
        log(f"  {KERNELS[k][0]}: {ms:.3f} ms over {launches[k]} launches "
            "(median of warm runs)")
    cost = {}
    for name, args, _, _ in recs:
        b, ops = launch_cost(name, args)
        c = cost.setdefault(name, [0, 0])
        c[0] += b
        c[1] += ops

    check_full_width(batch, values, rng)
    return {"batch": batch, "cold_s": cold_s, "warm_s": warm_s,
            "launches": launches, "kernel_ms": kernel_ms, "cost": cost,
            "peak_bytes": peak}


def check_full_width(batch, values, rng):
    """Hold the full-width result against the plain versions on subsets."""
    import torch
    from plonky2_tpu_torch.field import fft
    from plonky2_tpu_torch.hash import poseidon as pos
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    from plonky2_tpu_torch.utils.bits import bit_reverse_indices
    n = values.shape[1]
    m = n << RATE_BITS
    dev = values.device
    leaves = batch.leaves_dev
    levels = batch.merkle_tree.levels_dev
    check(tuple(leaves.shape) == (NUM_POLYS, m), f"leaves {leaves.shape}")
    check(tuple(levels[-1].shape) == (4, 1 << CAP_HEIGHT), "cap shape")

    rows = torch.from_numpy(np.sort(rng.choice(NUM_POLYS, 8, replace=False)))
    rows = rows.to(dev)
    coeffs = fft.ifft(values[rows])
    check(max_abs_err(coeffs, batch.coeffs_dev[rows]) == 0,
          "coefficients differ from the plain IFFT")
    padded = torch.cat([coeffs, coeffs.new_zeros((8, m - n))], dim=1)
    perm = torch.from_numpy(bit_reverse_indices(m)).to(dev)
    lde = fft.coset_fft(padded)[:, perm]
    check(max_abs_err(lde, leaves[rows]) == 0,
          "leaf rows differ from the plain coset LDE")
    log(f"  8 polynomials {rows.tolist()}: plain IFFT and LDE equal")
    del padded, lde, coeffs

    cols = torch.from_numpy(np.sort(rng.choice(m, 4096, replace=False)))
    cols = cols.to(dev)
    dig = pos.hash_leaves_cols(leaves[:, cols])
    check(max_abs_err(dig, levels[0][:, cols]) == 0,
          "leaf digests differ from the plain sponge")
    log("  plain sponge on 4096 sampled leaf columns: equal")
    checked = 0
    for k in range(1, len(levels)):
        if levels[k].shape[1] <= 1 << 14:
            want = pc.compress_level(levels[k - 1])
            check(max_abs_err(levels[k], want) == 0,
                  f"level {k} differs from the plain compress")
            checked += 1
    check(checked > 0, "no level was checked")
    log(f"  plain compress on the {checked} levels of <= 2^14 nodes down to "
        "the cap: equal")


def phase_openings(batch, rng):
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.hash.merkle import verify_merkle_proof_to_cap
    tree = batch.merkle_tree
    idx = [int(i) for i in rng.integers(0, tree.num_leaves, NUM_QUERIES)]
    tree.prefetch(idx)
    for i in idx:
        row = tree.get(i)
        check(row.shape == (NUM_POLYS,), f"row {i} shape {row.shape}")
        check(verify_merkle_proof_to_cap(row, i, tree.cap, tree.prove(i)),
              f"opening {i} does not verify against the cap")
    log(f"  {len(idx)} openings verify against the cap")
    bad = tree.get(idx[0]).copy()
    bad[-1] = (int(bad[-1]) + 1) % P
    check(not verify_merkle_proof_to_cap(bad, idx[0], tree.cap,
                                         tree.prove(idx[0])),
          "a corrupted leaf verified")
    log("  leaf with one changed element: rejected")


def kernels_line(kern, full, smi) -> dict:
    out = []
    for entry, (name, source, replaces) in KERNELS.items():
        nbytes, muls = full["cost"][entry]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = muls / INT32_MULS_PER_S * 1e3
        k = kern[entry]
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": full["launches"][entry],
            "max_abs_err": k["max_abs_err"], "ms": full["kernel_ms"][entry],
            "plain_ms": k["plain_ms"], "plain_shape": k["plain_shape"],
            "kernel_ms_at_plain_shape": k["kernel_ms_at_plain_shape"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes, "bound_int32_muls": muls,
            "library_ms": None})
    return {"kernels": out, "card": smi}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with phase("1 device"):
        smi = phase_device(dev)
    with phase("2 build"):
        phase_build()
    with phase("3 kernels vs plain (reduced shapes, exact)"):
        kern = phase_kernels(dev)
    rng = np.random.default_rng(SEED)
    with phase(f"4 full width ({NUM_POLYS} x 2^{LOG_N}, rate {RATE_BITS}, "
               f"cap {CAP_HEIGHT})"):
        full = phase_full_width(dev, rng)
    with phase(f"5 openings ({NUM_QUERIES} queries)"):
        phase_openings(full["batch"], rng)
    with phase("6 kernels line"):
        line = kernels_line(kern, full, smi)
    print(json.dumps(line), flush=True)
    print(f"total seconds: {time.perf_counter() - T0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
