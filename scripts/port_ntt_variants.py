"""Time design variants of the NTT kernels (csrc/ntt.cu) at the commit
path's shapes on one CUDA card.

    python3 scripts/port_ntt_variants.py [--reps N] [--only NAME,...]

Each variant is a copy of ``plonky2_tpu_torch/`` under the temporary
directory with text edits to its ``csrc/ntt.cu`` (VARIANTS below: each
undoes one design step of the source as it stands, some by an early
return ahead of the code they replace; the two diagnostics strip the
butterflies' arithmetic, or the device-memory traffic).  All copies are
built in parallel, each into its own ``build/``; then each variant is timed
in a process of its own, in turns, ``--reps`` times.  A process times, with
CUDA events (median of 5 launches after one warm-up), on random inputs:

* K5 down the columns of the wires LDE: (234, 128, 2048) with a tail of
  896 rows, pre (the coset shift) and post (the step-2 twiddles);
* K5's row form in place on (234, 1024, 2048);
* K3 down the columns of (234, 512, 512) with post, inverse (the IFFT's
  first pass), and K3's row form with the transposed store (its second);
* K4 on (20, 128, 2048), rate bits 3, with pre and post (the Z/PP LDE).

and prints checksums of every output, which must equal those of the
source as it stands for every variant but the diagnostics.  One JSON line
per run, and the card's name and power limit first.
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
BUTTERFLY = """  const uint64_t d = sub_canon(x, y);
  x = add_canon(x, y);
  y = mul_canon(d, w);"""
BUTTERFLY1 = """  const uint64_t d = sub_canon(x, y);
  x = add_canon(x, y);
  y = d;"""
ADD_SELECT = ("      \"lop3.b32 s0, s0, t0, c, 0xe4;\\n\\t\"\n"
              "      \"lop3.b32 s1, s1, t1, c, 0xe4;\\n\\t\"")
MUL_START = "  uint64_t lo, hi, r;\n  gl::mul_wide_split(a, b, lo, hi);\n"
VARIANTS = {
    "as is": [],
    "setp and selp in add": [
        (ADD_SELECT, "      \"setp.ne.u32 q, c, 0;\\n\\t\"\n"
         "      \"selp.b32 s0, s0, t0, q;\\n\\t\"\n"
         "      \"selp.b32 s1, s1, t1, q;\\n\\t\""),
        ("s0, s1, t0, t1, c;\\n\\t\"", "s0, s1, t0, t1, c;\\n\\t.reg .pred q;"
         "\\n\\t\"")],
    "reduce128_cc and canon": [
        (MUL_START, "  return gl::canon(gl::mul_nc_split(a, b));\n"
         + MUL_START)],
    "no register cap": [
        ("COL_MIN_BLOCKS = 2;", "COL_MIN_BLOCKS = 1;"),
        ("ROW_MIN_BLOCKS = 4;", "ROW_MIN_BLOCKS = 1;")],
    "80 registers (3 blocks of 256)": [
        ("COL_MIN_BLOCKS = 2;", "COL_MIN_BLOCKS = 3;"),
        ("ROW_THREADS = 128;", "ROW_THREADS = 256;"),
        ("ROW_MIN_BLOCKS = 4;", "ROW_MIN_BLOCKS = 3;")],
    "natural store in slot order": [
        ("    constexpr int j = rev_const(I, K);\n"
         "    y[I * rs] = post ? mul_canon(v[j], f[I * rs]) : v[j];",
         "    const int64_t o = rev_const(I, K) * rs;\n"
         "    y[o] = post ? mul_canon(v[I], f[o]) : v[I];")],
    "mul_wide product": [
        (MUL_START, "  return gl::mul(a, b);\n" + MUL_START)],
    "split product + C reduce128": [
        (MUL_START, "  {\n    uint64_t l, h;\n"
         "    gl::mul_wide_split(a, b, l, h);\n"
         "    return gl::canon(gl::reduce128(l, h));\n  }\n" + MUL_START)],
    "mul_wide product + reduce128_cc": [
        (MUL_START, "  {\n    uint64_t l, h;\n    gl::mul_wide(a, b, l, h);\n"
         "    return gl::canon(gl::reduce128_cc(l, h));\n  }\n" + MUL_START)],
    "goldilocks.cuh add and sub": [
        (BUTTERFLY, BUTTERFLY.replace("sub_canon", "gl::sub")
         .replace("add_canon", "gl::add")),
        (BUTTERFLY1, BUTTERFLY1.replace("sub_canon", "gl::sub")
         .replace("add_canon", "gl::add"))],
    "no w = 1 skip": [
        ("      if (m == 0 && s_lo == 0) {", "      if (false) {")],
    "diagnostic: butterflies without arithmetic": [
        (BUTTERFLY, "  x ^= y;\n  y ^= w;"), (BUTTERFLY1, "  x ^= y;")],
    # the row form makes its input from indices and stores almost nothing;
    # the column form writes almost none of its output
    "diagnostic: no data in or out": [
        ("for (int j = 0; j < (1 << K); j++) v[j] = x[j << s_lo];",
         "for (int j = 0; j < (1 << K); j++)"
         " v[j] = (uint64_t)(x + (j << s_lo)) * 0x9E3779B97F4A7C15ull >> 2;"),
        ("        dst[e] = cx.work[(e >> log_n2) * cx.S + pad(e & (N - 1))];",
         "        if (cx.work[(e >> log_n2) * cx.S + pad(e & (N - 1))] == 1)"
         " dst[e] = 1;"),
        ("    y[I * rs] = post ? mul_canon(v[j], f[I * rs]) : v[j];",
         "    const uint64_t r = post ? mul_canon(v[j], f[I * rs]) : v[j];\n"
         "    if (r == 1) y[I * rs] = r;"),
        ("y[i * rs] = post ? mul_canon(v[i], f[i * rs]) : v[i];",
         "{ const uint64_t r = post ? mul_canon(v[i], f[i * rs]) : v[i];"
         " if (r == 1) y[i * rs] = r; }")],
}
DIAGNOSTIC = ("diagnostic: butterflies without arithmetic",
              "diagnostic: no data in or out")


def worker(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.ops import ntt_cuda as nc
    kernels.library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rnd(*shape):    # below 2^62 < p: canonical field elements
        return torch.randint(0, 1 << 62, shape, dtype=torch.int64,
                             device=dev, generator=gen)

    def checksum(t):
        t = t.reshape(-1)
        w = torch.arange(1, t.numel() + 1, device=dev, dtype=torch.int64)
        return [int(t.sum()), int((t * w).sum())]

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        out = []
        for _ in range(reps):
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            out.append(s.elapsed_time(e))
        return sorted(out)[len(out) // 2]

    res, sums = {}, {}
    pre, post, x = rnd(128, 2048), rnd(1024, 2048), rnd(234, 128, 2048)
    res["K5 cols"] = ms(lambda: nc.ntt_cols_dif_cuda(x, 896, pre=pre,
                                                     post=post))
    y = nc.ntt_cols_dif_cuda(x, 896, pre=pre, post=post)
    sums["K5 cols"] = checksum(y)
    del x
    res["K5 rows in place"] = ms(lambda: nc.ntt_rows_dif_cuda(y))
    z = rnd(234, 1024, 2048)
    nc.ntt_rows_dif_cuda(z)
    sums["K5 rows in place"] = checksum(z)
    del y, z
    a, p5 = rnd(234, 512, 512), rnd(512, 512)
    res["K3 cols"] = ms(lambda: nc.ntt_cols_cuda(a, True, post=p5))
    sums["K3 cols"] = checksum(nc.ntt_cols_cuda(a, True, post=p5))
    res["K3 rows transposed"] = ms(lambda: nc.ntt_rows_cuda(a, True))
    sums["K3 rows transposed"] = checksum(nc.ntt_rows_cuda(a, True))
    q, pq, postq = rnd(20, 128, 2048), rnd(128, 2048), rnd(1024, 2048)
    res["K4"] = ms(lambda: nc.ntt_cols_zero_tail_cuda(q, 3, pre=pq,
                                                      post=postq))
    sums["K4"] = checksum(nc.ntt_cols_zero_tail_cuda(q, 3, pre=pq,
                                                     post=postq))
    return {"ms": res, "checksums": sums}


def copy_variant(name: str, edits, tmp: str) -> str:
    root = os.path.join(tmp, f"v{list(VARIANTS).index(name)}")
    shutil.copytree(os.path.join(REPO, "plonky2_tpu_torch"),
                    os.path.join(root, "plonky2_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(root, "plonky2_tpu_torch", "csrc", "ntt.cu")
    with open(path) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name!r}: {old!r} is not in ntt.cu")
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
             " if 'registers' in l or 'spill' in l))", r],
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
            for n in names:
                r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                    "--worker", roots[n]],
                                   capture_output=True, text=True, timeout=600)
                if r.returncode:
                    print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
                    return 1
                res = json.loads(r.stdout.strip().splitlines()[-1])
                if n == "as is":
                    ref = res["checksums"]
                same = None if ref is None or n in DIAGNOSTIC else \
                    res["checksums"] == ref
                print(json.dumps({"variant": n, "rep": rep, "ms": res["ms"],
                                  "checksums_equal_as_is": same}), flush=True)
                if same is False:
                    print(f"variant {n!r} computes other values",
                          file=sys.stderr)
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
