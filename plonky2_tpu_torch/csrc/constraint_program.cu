// Kernel K6: the constraint-program interpreter.
//
// Replaces plonky2_tpu/plonk/constraint_program.py:
// ConstraintProgram.pallas_chunk_runner (the Pallas register machine) and
// computes what run_numpy computes on a chunk of C lanes: registers
// [0, n_inputs) hold the inputs, the waves run in order, and the result is
// regs[out_regs].  Eight opcodes (constraint_program.py ADD .. MULADDS);
// operand b is a scalar-bank slot for ADDS, SUBS, MULS and MULADDS and a
// register otherwise.  Field arithmetic is goldilocks.cuh's add/sub/mul,
// the same formulas as the port's gf.py and the JAX package's gf_jax.
//
// Bound on an H100: the flagship program does 3,232 real 64x64 products
// per lane (12,928 32-bit products) against 345 words in and out, so by
// int32 multiply throughput and HBM bytes alike it is ~1.6-1.7 ms for 2^21
// lanes.  This first design is the simple correct one and is far from
// that: one thread per lane; the register file (822 words a lane, 6.6 KB)
// fits neither thread registers nor shared memory, so it lives in device
// memory as (n_regs, C) with lanes contiguous, and every operand access of
// a warp is one coalesced 256-byte row segment.  The register-file traffic
// is what bounds it.  The wave stream is warp-uniform: one 16-byte
// (dst, a, b, c) load per slot, served from L1.
//
// Within a wave, all W results are computed into thread registers before
// any is stored: the allocator hands a register that dies in wave w to one
// of wave w's results, so a slot may overwrite a register that a later
// slot of the same wave still reads.  Stores go in slot order, so of the
// padded slots, which all write the dump register, the last one wins.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int MAX_W = 32;
constexpr int THREADS = 256;

__global__ void constraint_program_kernel(uint64_t* __restrict__ regs,
                                          uint64_t* __restrict__ out,
                                          const int* __restrict__ opcodes,
                                          const int4* __restrict__ slots,
                                          const uint64_t* __restrict__ bank,
                                          const int* __restrict__ out_regs, int n_waves,
                                          int W, int n_out, int64_t C) {
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= C) return;
  uint64_t* r = regs + lane;
  for (int w = 0; w < n_waves; w++) {
    const int code = opcodes[w];
    const int4* ws = slots + (int64_t)w * W;
    const bool scalar_b = code == 3 || code == 4 || code == 5 || code == 7;
    uint64_t vals[MAX_W];
#pragma unroll
    for (int k = 0; k < MAX_W; k++) {
      if (k < W) {
        const int4 s = ws[k];  // (dst, a, b, c)
        const uint64_t x = r[(int64_t)s.y * C];
        const uint64_t y = scalar_b ? bank[s.z] : r[(int64_t)s.z * C];
        uint64_t v;
        switch (code) {
          case 0:  // ADD
          case 3:  // ADDS
            v = gl::add(x, y);
            break;
          case 1:  // SUB
            v = gl::sub(x, y);
            break;
          case 4:  // SUBS: s[b] - r[a]
            v = gl::sub(y, x);
            break;
          case 2:  // MUL
          case 5:  // MULS
            v = gl::mul(x, y);
            break;
          default:  // 6 MULADD, 7 MULADDS
            v = gl::add(gl::mul(x, y), r[(int64_t)s.w * C]);
            break;
        }
        vals[k] = v;
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_W; k++) {
      if (k < W) r[(int64_t)ws[k].x * C] = vals[k];
    }
  }
  for (int i = 0; i < n_out; i++) out[(int64_t)i * C + lane] = r[(int64_t)out_regs[i] * C];
}

}  // namespace

// regs: (n_regs, C) with rows [0, n_inputs) preloaded; overwritten.
// out: (n_out, C).  slots: (n_waves, W) int4 (dst, a, b, c).
extern "C" int plk_constraint_program(void* regs, void* out, const void* opcodes,
                                      const void* slots, const void* bank,
                                      const void* out_regs, int n_waves, int W, int n_out,
                                      long long C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W < 1 || W > MAX_W) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const unsigned blocks = (unsigned)((C + THREADS - 1) / THREADS);
  constraint_program_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (uint64_t*)regs, (uint64_t*)out, (const int*)opcodes, (const int4*)slots,
      (const uint64_t*)bank, (const int*)out_regs, n_waves, W, n_out, (int64_t)C);
  return (int)cudaGetLastError();
}
