// Kernel K6: the constraint-program interpreter, over the linear form.
//
// Replaces plonky2_tpu/plonk/constraint_program.py:
// ConstraintProgram.pallas_chunk_runner (the Pallas register machine) and
// computes what run_numpy computes on a chunk of C lanes.  It runs the
// program as plonk/constraint_program.py:linearize rewrites it: the real
// ops only, in an order that keeps few values live, each value in one of
// n_slots slots.  One op is one uint64 (opcode | dst | a | b | c, see
// linearize); an operand is a slot, or a row of the (n_read, C) input
// matrix, read from device memory at its use and, at an input's first use
// when later ops read it too, stored into its slot (input_slot[row]).
// Eight opcodes (constraint_program.py ADD .. MULADDS); operand b is a bank
// slot for ADDS, SUBS, MULS and MULADDS.  Field arithmetic is
// goldilocks.cuh's add/sub/mul, the same formulas as the port's gf.py and
// the JAX package's gf_jax.
//
// Bound on an H100: the flagship program does 3,232 real 64x64 products
// per lane (12,928 32-bit products) against 246 words in and out (the 244
// input rows it reads, 2 outputs), so by int32 multiply throughput it is
// ~1.6 ms for 2^21 lanes (HBM bytes ~1.2 ms).  Design: one thread per lane; the lane's slots live in shared
// memory as (n_slots, T) with lanes contiguous, so a warp's access to one
// slot is one 256-byte row segment (two wavefronts, no bank conflict), and
// T lanes a block are as many as 8 * (n_slots * T + bank_size) bytes allow
// (the flagship program's 211 slots and 857 bank words: T = 128, 218 KB).
// The scalar bank is copied to shared memory too.  No register file lives
// in device memory: inputs are read where they are used and outputs
// written once.  The op stream is warp-uniform: each warp loads 32 ops at
// a time, one a lane (one 256-byte load, the next batch in flight while
// this one runs), and hands op k to all lanes with __shfl_sync.
//
// What bounds it: shared memory holds one 128-lane block an SM, so each
// scheduler runs one warp, and two thirds of the ops read the op just
// before, so each op waits out its predecessor's latency.  Tried and
// measured slower (PERF.md): software pipelining by one op, L1
// prefetch of inputs, forwarding the last result in a register, and the
// program generated as straight-line code (14% faster, 50-90 s of nvcc
// for each program).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr uint32_t OPERAND_INPUT = 0x8000;
constexpr uint32_t OPERAND_KEEP = 0x4000;
constexpr uint32_t OPERAND_INDEX = 0x3FFF;
constexpr int MAX_SHARED = 232448;  // dynamic shared memory a block may use (sm_90)

struct Lane {
  const uint64_t* in;     // this lane's column of the input matrix
  int64_t C;              // input row stride
  uint64_t* sm;           // this lane's column of the slots
  int T;                  // slot stride
  const int* input_slot;  // slot of each kept input row
  const uint64_t* bank;   // the scalar bank, in shared memory
};

__device__ __forceinline__ uint64_t fetch(uint32_t f, const Lane& l) {
  if (f & OPERAND_INPUT) {
    const uint32_t row = f & OPERAND_INDEX;
    const uint64_t v = __ldg(l.in + (int64_t)row * l.C);
    if (f & OPERAND_KEEP) l.sm[__ldg(l.input_slot + row) * l.T] = v;
    return v;
  }
  return l.sm[(int)f * l.T];
}

__device__ __forceinline__ void run_op(uint64_t op, const Lane& l) {
  const uint32_t code = (uint32_t)op & 15u;
  const uint32_t dst = (uint32_t)(op >> 4) & 0xFFFu;
  const uint32_t fa = (uint32_t)(op >> 16) & 0xFFFFu;
  const uint32_t fb = (uint32_t)(op >> 32) & 0xFFFFu;
  const uint32_t fc = (uint32_t)(op >> 48);
  const uint64_t x = fetch(fa, l);
  uint64_t v;
  switch (code) {
    case 0:  // ADD
      v = gl::add(x, fetch(fb, l));
      break;
    case 1:  // SUB
      v = gl::sub(x, fetch(fb, l));
      break;
    case 2:  // MUL
      v = gl::mul(x, fetch(fb, l));
      break;
    case 3:  // ADDS
      v = gl::add(x, l.bank[fb]);
      break;
    case 4:  // SUBS: s[b] - r[a]
      v = gl::sub(l.bank[fb], x);
      break;
    case 5:  // MULS
      v = gl::mul(x, l.bank[fb]);
      break;
    case 6: {  // MULADD
      const uint64_t y = fetch(fb, l);
      v = gl::add(gl::mul(x, y), fetch(fc, l));
      break;
    }
    default:  // 7 MULADDS
      v = gl::add(gl::mul(x, l.bank[fb]), fetch(fc, l));
      break;
  }
  l.sm[(int)dst * l.T] = v;
}

// Lanes past C (the last block's tail) run on lane C - 1's inputs and
// store nothing, so that every lane of a warp takes part in the shuffles.
__global__ void __launch_bounds__(128)
linear_program_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                      const uint64_t* __restrict__ ops, int n_ops,
                      const uint64_t* __restrict__ bank, int bank_size,
                      const int* __restrict__ input_slot,
                      const int* __restrict__ out_operands, int n_out, int n_slots, int64_t C) {
  extern __shared__ uint64_t shared[];
  const int T = blockDim.x;
  uint64_t* sbank = shared + (int64_t)n_slots * T;
  for (int i = threadIdx.x; i < bank_size; i += T) sbank[i] = __ldg(bank + i);
  __syncthreads();
  const int64_t lane = (int64_t)blockIdx.x * T + threadIdx.x;
  const int64_t src = lane < C ? lane : C - 1;
  const Lane l{in + src, C, shared + threadIdx.x, T, input_slot, sbank};
  const int wl = threadIdx.x & 31;
  uint64_t batch = wl < n_ops ? __ldg(ops + wl) : 0;
  for (int base = 0; base < n_ops; base += 32) {
    const int nxt = base + 32 + wl;
    const uint64_t next = nxt < n_ops ? __ldg(ops + nxt) : 0;
    const int count = min(32, n_ops - base);
    for (int k = 0; k < count; k++) run_op(__shfl_sync(0xFFFFFFFFu, batch, k), l);
    batch = next;
  }
  if (lane >= C) return;
  for (int i = 0; i < n_out; i++)
    out[(int64_t)i * C + lane] = fetch((uint32_t)__ldg(out_operands + i) & ~OPERAND_KEEP, l);
}

}  // namespace

// in: (n_read, C) input rows; out: (n_out, C).  ops: (n_ops,) packed;
// bank: (bank_size,); input_slot: (n_read,) int32; out_operands: (n_out,)
// int32.  T lanes a block: the most of 128, 64, 32 whose slots and bank fit
// shared memory.
extern "C" int plk_constraint_program(const void* in, void* out, const void* ops, int n_ops,
                                      const void* bank, int bank_size, const void* input_slot,
                                      const void* out_operands, int n_out, int n_slots,
                                      long long C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_slots < 0 || n_ops < 0 || n_out < 0 || bank_size < 0) return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  int T = 128;
  while (T > 32 && (int64_t)8 * ((int64_t)n_slots * T + bank_size) > MAX_SHARED) T /= 2;
  const int64_t smem = (int64_t)8 * ((int64_t)n_slots * T + bank_size);
  if (smem > MAX_SHARED) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(linear_program_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((C + T - 1) / T);
  linear_program_kernel<<<blocks, T, (size_t)smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)ops, n_ops, (const uint64_t*)bank,
      bank_size, (const int*)input_slot, (const int*)out_operands, n_out, n_slots, (int64_t)C);
  return (int)cudaGetLastError();
}
