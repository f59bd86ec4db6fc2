"""Time design variants of K2's narrow top (csrc/poseidon.cu:
compress_tail_kernel) on one CUDA card.

    python3 scripts/port_merkle_tail_variants.py [--reps N] [--only NAME,...]

Each variant is a copy of ``plonky2_tpu_torch/`` under the temporary
directory with text edits to its ``csrc/poseidon.cu`` (VARIANTS below):
the lanes a permutation is split across (g = 1, 2, 8 and 16 against the
source's 4; g = 1 is the single launch without the lane split), block
barriers in place of grid barriers on the top levels, the S-box in the
latency forms, more registers a thread, and a
diagnostic that reads clock64() at the permutation's phases, the grid
barriers and the whole kernel in thread 0 of block 0.  All copies
are built in parallel, each into its own ``build/``; then each variant is
timed in a process of its own, in turns, ``--reps`` times.  A process
times, with CUDA events, the narrow top from m0 = 2^16, 2^15 and 2^14
parents down to 16 (13, 12 and 11 levels; the threshold T of
hash/merkle_torch.py) and from 16 parents (one level, FRI layer 3): each
queued behind K1 on a (234, 2^18) leaf matrix, so that the events read
device time only (median of 5), and the 11 levels also host-paced, on an
idle card, and one level at each width from 2^6 to 2^14 parents.  It
prints checksums of every output, which must equal those of the source as
it stands (the diagnostic's differ: it writes its clocks over the first
words of the first level).  One JSON line per run, the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = "constexpr int TAIL_LANES = 4;"
BOUNDS = "__launch_bounds__(TAIL_THREADS, 4)"
SBOX = """  uint64_t x2 = gl::square_nc_split(x);
  uint64_t x3 = gl::mul_nc_split(x2, x);
  uint64_t x4 = gl::square_nc_split(x2);
  return gl::mul_nc_split(x3, x4);"""
# clock64() at the permutation's phases, in thread 0 of block 0, written
# over the first words of the first level's output (so its checksums differ)
PERMUTE = ("template <int G>\n__device__ void permute_lanes(LaneState<G>& st, "
           "int lane, const TailTables& t) {")
CLOCKS = [
    (PERMUTE, "__device__ long long tail_clocks[6];\n\n" + PERMUTE
     + "\n  long long ck0 = clock64();"),
    ("  for (int r = 0; r < 4; r++) full_round_lanes(st, lane, r, t);\n",
     "  for (int r = 0; r < 4; r++) full_round_lanes(st, lane, r, t);\n"
     "  long long ck1 = clock64();\n"),
    ("  uint64_t s0 = x[0];", "  long long ck2 = clock64();\n  uint64_t s0 = x[0];"),
    ("  if (lane == 0) st.s[0] = s0;\n",
     "  long long ck3 = clock64();\n  if (lane == 0) st.s[0] = s0;\n"),
    ("  for (int r = 4; r < 8; r++) full_round_lanes(st, lane, r, t);\n}",
     "  for (int r = 4; r < 8; r++) full_round_lanes(st, lane, r, t);\n"
     "  long long ck4 = clock64();\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
     "    tail_clocks[0] = ck1 - ck0; tail_clocks[1] = ck2 - ck1;\n"
     "    tail_clocks[2] = ck3 - ck2; tail_clocks[3] = ck4 - ck3;\n  }\n}"),
    ("  int64_t m = m0;\n  for (int level = 0;",
     "  int64_t m = m0;\n  long long k_start = clock64(), k_sync = 0;\n"
     "  for (int level = 0;"),
    ("    if (level + 1 < n_levels) grid.sync();",
     "    long long k_s = clock64();\n"
     "    if (level + 1 < n_levels) grid.sync();\n"
     "    k_sync += clock64() - k_s;"),
    ("    m >>= 1;\n  }\n}",
     "    m >>= 1;\n  }\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
     "    tail_clocks[4] = k_sync; tail_clocks[5] = clock64() - k_start;\n"
     "    for (int j = 0; j < 6; j++) out[j] = tail_clocks[j];\n  }\n}"),
]
CLOCK_NAMES = ["4 full rounds", "initial matrix", "22 partial rounds",
               "4 full rounds (end)", "grid barriers", "kernel"]
VARIANTS = {
    "as is (g = 4)": [],
    # the levels where each of `local` blocks can take m / local nodes in
    # one pass (the top 6 of a 2^21-leaf tree), walked block by block with
    # block barriers: a block's run of nodes holds its next run's children
    "block barriers on the top levels": [
        ("  int64_t m = m0;\n  for (int level = 0; level < n_levels; level++) {\n"
         "    // warp-uniform bounds: every lane of a warp reaches every shuffle\n"
         "    for (int64_t base = warp * NODES_PER_WARP; base < m; base += n_warps * NODES_PER_WARP) {\n"
         "      const int64_t node = base + group;\n"
         "      const int64_t i = node < m ? node : m - 1;",
         "  int64_t m = m0;\n  int64_t local = m0 >> (n_levels - 1);\n"
         "  while (local > gridDim.x) local >>= 1;\n"
         "  for (int level = 0; level < n_levels; level++) {\n"
         "    const bool by_block = m <= local * (TAIL_THREADS / G);\n"
         "    if (by_block && blockIdx.x >= local) return;\n"
         "    const int64_t lo = by_block ? blockIdx.x * (m / local) : 0;\n"
         "    const int64_t hi = by_block ? lo + m / local : m;\n"
         "    const int64_t w0 = by_block ? threadIdx.x / 32 : warp;\n"
         "    const int64_t ws = by_block ? TAIL_THREADS / 32 : n_warps;\n"
         "    for (int64_t base = lo + w0 * NODES_PER_WARP; base < hi; base += ws * NODES_PER_WARP) {\n"
         "      const int64_t node = base + group;\n"
         "      const int64_t i = node < hi ? node : hi - 1;"),
        ("        if (w < 4 && node < m) dst[w * m + node]",
         "        if (w < 4 && node < hi) dst[w * m + node]"),
        ("    if (level + 1 < n_levels) grid.sync();",
         "    if (level + 1 < n_levels) {\n"
         "      if (by_block) __syncthreads(); else grid.sync();\n    }")],
    "g = 1": [(LANES, LANES.replace("4", "1"))],
    "g = 2": [(LANES, LANES.replace("4", "2"))],
    "g = 8": [(LANES, LANES.replace("4", "8"))],
    "g = 16": [(LANES, LANES.replace("4", "16"))],
    "g = 4, S-box in the latency forms (mul_nc; K1 too)": [
        (SBOX, SBOX.replace("gl::square_nc_split(x)", "gl::mul_nc(x, x)")
         .replace("gl::square_nc_split(x2)", "gl::mul_nc(x2, x2)")
         .replace("mul_nc_split", "mul_nc"))],
    "g = 4, up to 255 registers": [(BOUNDS, BOUNDS.replace("4)", "2)"))],
    "diagnostic: clocks, g = 4": CLOCKS,
    "diagnostic: clocks, g = 16": CLOCKS + [(LANES, LANES.replace("4", "16"))],
}
DIAGNOSTIC = ("diagnostic: clocks, g = 4", "diagnostic: clocks, g = 16")


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.hash import poseidon_cuda as pc
    kernels.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):    # below 2^62 < p: canonical field elements
        return torch.randint(0, 1 << 62, shape, dtype=torch.int64,
                             device=dev, generator=gen)

    def checksum(levels):
        t = torch.cat([x.reshape(-1) for x in levels])
        w = torch.arange(1, t.numel() + 1, device=dev, dtype=torch.int64)
        return [int(t.sum()), int((t * w).sum())]

    leaves = rnd(234, 1 << 18)

    def ms(fn, behind, reps=5):
        fn()
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            if behind:
                pc.hash_leaves_cols_cuda(leaves)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e))
        return sorted(out)[len(out) // 2]

    res, sums, clocks = {}, {}, {}
    for log_m0 in (16, 15, 14, 4):
        x = rnd(4, 2 << log_m0)
        n = log_m0 - 3
        key = f"m0=2^{log_m0}, {n} levels"
        res[key + ", device"] = ms(lambda: pc.compress_tail_cuda(x, n), True)
        if log_m0 == 14:
            res[key + ", host-paced"] = ms(
                lambda: pc.compress_tail_cuda(x, n), False)
        out = pc.compress_tail_cuda(x, n)
        sums[key] = checksum(out)
        clocks[key] = [int(v) for v in out[0].reshape(-1)[:6]]
    # one level at each width: where a level stops being one permutation's
    # latency
    for log_m in (6, 8, 10, 11, 12, 13, 14):
        x = rnd(4, 2 << log_m)
        res[f"one level of 2^{log_m}, device"] = ms(
            lambda: pc.compress_tail_cuda(x, 1), True)
    return {"ms": res, "checksums": sums, "clocks": clocks}


def copy_variant(name: str, edits, tmp: str) -> str:
    root = os.path.join(tmp, f"v{list(VARIANTS).index(name)}")
    shutil.copytree(os.path.join(REPO, "plonky2_tpu_torch"),
                    os.path.join(root, "plonky2_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "plonky2_tpu_torch", "csrc", "poseidon.cu")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in "
                               "poseidon.cu")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return root


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--only")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    names = args.only.split(",") if args.only else list(VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        roots = {n: copy_variant(n, VARIANTS[n], tmp) for n in names}
        builds = {n: subprocess.Popen(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]);"
             " from plonky2_tpu_torch import kernels; i = kernels.build();"
             " print('\\n'.join(l.strip() for l in i['log'].splitlines()"
             " if 'tail' in l or 'registers' in l or 'spill' in l))", r],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n, r in roots.items()}
        for n, proc in builds.items():
            out, _ = proc.communicate()
            print(json.dumps({"variant": n, "build_rc": proc.returncode,
                              "ptxas": out.splitlines()}), flush=True)
            if proc.returncode:
                return 1
        ref = None
        for rep in range(args.reps):
            for n in (names if rep % 2 == 0 else names[::-1]):
                r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                    "--worker", roots[n]],
                                   capture_output=True, text=True, timeout=600)
                if r.returncode:
                    print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                    return 1
                res = json.loads(r.stdout.strip().splitlines()[-1])
                ref = ref or res["checksums"]
                same = None if n in DIAGNOSTIC else res["checksums"] == ref
                line = {"variant": n, "rep": rep, "ms": res["ms"],
                        "checksums_equal": same}
                if n in DIAGNOSTIC:
                    line["clocks"] = {k: dict(zip(CLOCK_NAMES, v))
                                      for k, v in res["clocks"].items()}
                print(json.dumps(line), flush=True)
                if same is False:
                    print(f"variant {n!r} computes other values",
                          file=sys.stderr)
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
