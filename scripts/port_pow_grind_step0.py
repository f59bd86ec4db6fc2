"""Where the time of kernel K8 (the FRI proof-of-work grind) goes, on one
CUDA card.

    python3 scripts/port_pow_grind_step0.py [TREE] [--out F]

TREE (default: this checkout) is a checkout of the repository; the first
measurement below needs a tree whose ``plk_pow_grind`` takes the 12 words
from the host (buf, pos, bits, start, limit), and is skipped on others.  The script
copies its csrc/, appends to csrc/poseidon.cu a copy of the single-launch
grind as it stood before the grind read its state from the card's
transcript (one thread a candidate, chunks of blockDim.x candidates taken
in order from a ticket, atomicMin on the smallest pass) with stamps at its
blocks' entries and exits (%globaltimer, ns, across blocks; clock64 per
block), builds that copy into build/ and, on states made from numpy seed
0 at 16 bits (the flagship's), measures:

* CUDA events around the tree's own ``plk_pow_grind`` entry on an idle
  card (what chip_smoke.py's kernel recorder sees on a session proof,
  where a synchronising upload precedes the launch) and queued behind a
  3.5 ms K1 launch (device time only), and the host time of the entry
  call (its occupancy query and the launch);
* the stamped copy at the resident grid and at one block an SM: the span
  from the first block's entry to the last block's exit, the time of the
  first pass, the chunks taken and the longest block in cycles;
* in a tree whose grind runs its rounds in lockstep and keeps a record of
  its last launch (``hash/poseidon_cuda.py:grind_scratch``), that grind
  on the same states: CUDA events idle and behind K1, the host time of
  the call, block 0's span and the rounds.

It prints the card's name and power limit (``nvidia-smi``) and one JSON
line; ``--out`` also writes it as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import shutil
import subprocess
import sys
import time

BITS = 16
STATES = 8
REPS = 3

PROBE = r"""
namespace {
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// stamps: [0] first entry (ns), [1] last exit (ns), [2] first pass (ns),
// [3] chunks taken, [4] longest block (cycles)
__global__ void __launch_bounds__(THREADS, 1)
pow_grind_probe_kernel(unsigned long long* buf, int pos, int bits, uint64_t start, uint64_t limit,
                       unsigned long long* stamps) {
  constexpr unsigned long long NONE = ~0ull;
  const long long c0 = clock64();
  if (threadIdx.x == 0) atomicMin(stamps, probe_ns());
  __shared__ unsigned long long chunk;
  unsigned long long* best = buf + WIDTH;
  unsigned long long* ticket = buf + WIDTH + 1;
  const uint64_t bound = bits == 0 ? 0 : 1ull << (64 - bits);
  for (;;) {
    if (threadIdx.x == 0) {
      const unsigned long long s = start + atomicAdd(ticket, 1ull) * blockDim.x;
      chunk = s >= limit || s > __ldcg(best) ? NONE : s;
      if (chunk != NONE) atomicAdd(stamps + 3, 1ull);
    }
    __syncthreads();
    const unsigned long long s = chunk;
    __syncthreads();
    if (s == NONE) break;
    const uint64_t w = s + threadIdx.x;
    if (w < limit) {
      uint64_t st[WIDTH];
#pragma unroll
      for (int j = 0; j < WIDTH; j++) st[j] = j == pos ? w : (uint64_t)__ldg(buf + j);
      permute(st);
      if (bits == 0 || gl::canon(st[RATE - 1]) < bound) {
        atomicMin(best, (unsigned long long)w);
        atomicMin(stamps + 2, probe_ns());
      }
    }
  }
  if (threadIdx.x == 0) {
    atomicMax(stamps + 1, probe_ns());
    atomicMax(stamps + 4, (unsigned long long)(clock64() - c0));
  }
}
}  // namespace

extern "C" int plk_pow_grind_probe(void* buf, int pos, int bits, long long start, long long limit,
                                   int blocks, void* stamps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  pow_grind_probe_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)buf, pos, bits, (uint64_t)start, (uint64_t)limit,
      (unsigned long long*)stamps);
  return (int)cudaGetLastError();
}

extern "C" int plk_pow_grind_probe_occupancy(int* per_sm, int* sms, int device) {
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pow_grind_probe_kernel,
                                                                  THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}
"""


def build_probe(tree: str) -> str:
    """The tree's kernels with the stamped grind appended, built into
    build/k8-step0-<key>/ (reused when unchanged)."""
    from plonky2_tpu_torch import kernels
    header = kernels._poseidon_header()
    key = kernels._build_key(header + PROBE)
    out_dir = os.path.join(tree, "build", f"k8-step0-{key}")
    lib = os.path.join(out_dir, "libk8step0.so")
    if os.path.isfile(lib):
        return lib
    src_dir = os.path.join(out_dir, "src")
    os.makedirs(src_dir, exist_ok=True)
    for path in glob.glob(os.path.join(kernels.CSRC, "*")):
        if os.path.isfile(path):
            shutil.copy(path, src_dir)
    with open(os.path.join(src_dir, "poseidon.cu"), "a") as f:
        f.write(PROBE)
    with open(os.path.join(out_dir, "poseidon_constants.h"), "w") as f:
        f.write(header)
    kernels._compile([os.path.join(src_dir, "poseidon.cu")], out_dir, lib)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=".")
    ap.add_argument("--out")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from plonky2_tpu_torch import kernels
    from plonky2_tpu_torch.field.convert import from_u64
    from plonky2_tpu_torch.field.goldilocks import P
    from plonky2_tpu_torch.hash import poseidon_cuda as pc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.library()
    lib = ctypes.CDLL(build_probe(tree))
    probe = lib.plk_pow_grind_probe
    probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    occ = lib.plk_pow_grind_probe_occupancy
    occ.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    per_sm, sms = ctypes.c_int(), ctypes.c_int()
    assert occ(ctypes.byref(per_sm), ctypes.byref(sms), 0) == 0
    resident = per_sm.value * sms.value
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(0)
    leaves = from_u64(rng.integers(0, P, size=(234, 1 << 16),
                                   dtype=np.uint64), dev)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def fresh(base):
        return torch.cat([base, torch.tensor([-1, 0], dtype=torch.int64,
                                             device=dev)])

    results = []
    for k in range(STATES):
        base = from_u64(rng.integers(0, P, size=12, dtype=np.uint64), dev)
        word = k % 8
        witness = pc.pow_grind_cuda(base, word, BITS)      # warm-up, answer
        row = {"state": k, "word": word, "witness": witness}
        # the tree's own entry: idle card (upload first, as on a proof),
        # then queued behind K1; host time of the entry call
        old_entry = [n for n, _ in kernels.SIGNATURES["plk_pow_grind"]] == [
            "buf", "pos", "bits", "start", "limit", "device", "stream"]
        for mode in ("idle", "behind") if old_entry else ():
            ms, host = [], []
            for _ in range(REPS):
                buf = fresh(base)
                torch.cuda.synchronize()
                if mode == "behind":
                    pc.hash_leaves_cols_cuda(leaves)
                a = event()
                t = time.perf_counter()
                kernels.call("plk_pow_grind", buf.data_ptr(), word, BITS, 0,
                             pc.POW_LIMIT, 0, stream)
                host.append((time.perf_counter() - t) * 1e3)
                b = event()
                torch.cuda.synchronize()
                assert int(buf[12]) == witness
                ms.append(a.elapsed_time(b))
            row[f"entry_{mode}_ms"] = ms
            row[f"entry_{mode}_host_call_ms"] = host
        # a tree whose K8 keeps a record of its last launch (rounds in
        # lockstep): the wrapper's launch, idle and queued behind K1
        for mode in ("idle", "behind") if hasattr(pc, "grind_scratch") else ():
            runs = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                if mode == "behind":
                    pc.hash_leaves_cols_cuda(leaves)
                a = event()
                t = time.perf_counter()
                out = torch.full((1,), -1, dtype=torch.int64, device=dev)
                pc._launch_grind(base, base.data_ptr(), 0, word, BITS, 0,
                                 pc.POW_LIMIT, out, None)
                host_ms = (time.perf_counter() - t) * 1e3
                b = event()
                torch.cuda.synchronize()
                assert int(out[0]) == witness
                r = [int(x) for x in pc.grind_scratch(dev).tolist()]
                runs.append({"event_ms": a.elapsed_time(b),
                             "host_call_ms": host_ms,
                             "span_ms": (r[2] - r[1]) / 1e6,
                             "rounds": r[3]})
            row[f"lockstep_{mode}"] = runs
        # the stamped copy, queued behind K1
        for label, blocks in (("resident", resident), ("one_per_sm",
                                                       sms.value)):
            runs = []
            for _ in range(REPS):
                buf = fresh(base)
                stamps = torch.tensor([-1, 0, -1, 0, 0], dtype=torch.int64,
                                      device=dev)
                torch.cuda.synchronize()
                pc.hash_leaves_cols_cuda(leaves)
                a = event()
                rc = probe(buf.data_ptr(), word, BITS, 0, pc.POW_LIMIT,
                           blocks, stamps.data_ptr(), 0, stream)
                b = event()
                torch.cuda.synchronize()
                assert rc == 0 and int(buf[12]) == witness
                s = [int(x) & ((1 << 64) - 1) for x in stamps.tolist()]
                runs.append({"event_ms": a.elapsed_time(b),
                             "span_ms": (s[1] - s[0]) / 1e6,
                             "first_pass_ms": (s[2] - s[0]) / 1e6,
                             "chunks": s[3], "longest_block_cycles": s[4]})
            row[label] = runs
        results.append(row)
        print(json.dumps(row), flush=True)
    out = {"card": smi, "bits": BITS, "threads": 128,
           "per_sm": per_sm.value, "sms": sms.value, "resident": resident,
           "states": results}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "states"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
