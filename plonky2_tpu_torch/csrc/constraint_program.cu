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
//
// Programs of up to 4,096 slots (the op format's 12-bit dst; linearize
// raises past it).  The wrapper (plonk/constraint_program_cuda.py:
// k6_form) picks the form: 128, 64 or 32 lanes a block with every slot in
// shared memory where they fit, else 32 lanes a block with the first
// n_shared slots in shared memory and the rest in a device scratch buffer
// that the wrapper allocates, lane-minor (slot s of resident lane j at
// scratch[(s - n_shared) * scratch_lanes + j]), so that a warp's access is
// one 256-byte segment.  linearize numbers the slots by how often the
// program reads and writes them, most first, so the slots that stay in
// shared memory are the busiest.  The spilling form runs a grid of as many
// blocks as the scratch holds, each block walking lane tiles, and reads
// the bank from device memory when it is too large for shared memory.
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
  uint64_t* sm;           // this lane's column of the shared slots
  int T;                  // shared slot stride
  const int* input_slot;  // slot of each kept input row
  const uint64_t* bank;   // the scalar bank (shared memory, or device memory when spilling)
  uint32_t n_shared;      // slots in shared memory (all of them unless SPILL)
  uint64_t* scratch;      // this lane's column of the spilled slots (SPILL)
  int64_t scratch_lanes;  // spilled slot stride (SPILL)
};

template <bool SPILL>
__device__ __forceinline__ uint64_t* slot(uint32_t s, const Lane& l) {
  if (SPILL && s >= l.n_shared) return l.scratch + (int64_t)(s - l.n_shared) * l.scratch_lanes;
  return l.sm + (int)s * l.T;
}

template <bool SPILL>
__device__ __forceinline__ uint64_t fetch(uint32_t f, const Lane& l) {
  if (f & OPERAND_INPUT) {
    const uint32_t row = f & OPERAND_INDEX;
    const uint64_t v = __ldg(l.in + (int64_t)row * l.C);
    if (f & OPERAND_KEEP) *slot<SPILL>((uint32_t)__ldg(l.input_slot + row), l) = v;
    return v;
  }
  return *slot<SPILL>(f, l);
}

template <bool SPILL>
__device__ __forceinline__ void run_op(uint64_t op, const Lane& l) {
  const uint32_t code = (uint32_t)op & 15u;
  const uint32_t dst = (uint32_t)(op >> 4) & 0xFFFu;
  const uint32_t fa = (uint32_t)(op >> 16) & 0xFFFFu;
  const uint32_t fb = (uint32_t)(op >> 32) & 0xFFFFu;
  const uint32_t fc = (uint32_t)(op >> 48);
  const uint64_t x = fetch<SPILL>(fa, l);
  uint64_t v;
  switch (code) {
    case 0:  // ADD
      v = gl::add(x, fetch<SPILL>(fb, l));
      break;
    case 1:  // SUB
      v = gl::sub(x, fetch<SPILL>(fb, l));
      break;
    case 2:  // MUL
      v = gl::mul(x, fetch<SPILL>(fb, l));
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
      const uint64_t y = fetch<SPILL>(fb, l);
      v = gl::add(gl::mul(x, y), fetch<SPILL>(fc, l));
      break;
    }
    default:  // 7 MULADDS
      v = gl::add(gl::mul(x, l.bank[fb]), fetch<SPILL>(fc, l));
      break;
  }
  *slot<SPILL>(dst, l) = v;
}

// Each block runs lane tiles blockIdx.x, blockIdx.x + gridDim.x, ... (one
// tile a block unless SPILL).  Lanes past C (the last tile's tail) run on
// lane C - 1's inputs and store nothing, so that every lane of a warp
// takes part in the shuffles.
template <bool SPILL>
__global__ void __launch_bounds__(128)
linear_program_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                      const uint64_t* __restrict__ ops, int n_ops,
                      const uint64_t* __restrict__ bank, int bank_size, bool bank_shared,
                      const int* __restrict__ input_slot,
                      const int* __restrict__ out_operands, int n_out, int n_shared,
                      uint64_t* __restrict__ scratch, int64_t scratch_lanes, int64_t C) {
  extern __shared__ uint64_t shared[];
  const int T = blockDim.x;
  uint64_t* sbank = shared + (int64_t)n_shared * T;
  if (!SPILL || bank_shared) {
    for (int i = threadIdx.x; i < bank_size; i += T) sbank[i] = __ldg(bank + i);
    __syncthreads();
  }
  const int wl = threadIdx.x & 31;
  const int64_t n_tiles = (C + T - 1) / T;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t lane = tile * T + threadIdx.x;
    const int64_t src = lane < C ? lane : C - 1;
    const Lane l{in + src,
                 C,
                 shared + threadIdx.x,
                 T,
                 input_slot,
                 (!SPILL || bank_shared) ? sbank : bank,
                 (uint32_t)n_shared,
                 SPILL ? scratch + (int64_t)blockIdx.x * T + threadIdx.x : nullptr,
                 scratch_lanes};
    uint64_t batch = wl < n_ops ? __ldg(ops + wl) : 0;
    for (int base = 0; base < n_ops; base += 32) {
      const int nxt = base + 32 + wl;
      const uint64_t next = nxt < n_ops ? __ldg(ops + nxt) : 0;
      const int count = min(32, n_ops - base);
      for (int k = 0; k < count; k++) run_op<SPILL>(__shfl_sync(0xFFFFFFFFu, batch, k), l);
      batch = next;
    }
    if (lane < C)
      for (int i = 0; i < n_out; i++)
        out[(int64_t)i * C + lane] =
            fetch<SPILL>((uint32_t)__ldg(out_operands + i) & ~OPERAND_KEEP, l);
    if (SPILL) __syncwarp();
  }
}

}  // namespace

// in: (n_read, C) input rows; out: (n_out, C).  ops: (n_ops,) packed;
// bank: (bank_size,); input_slot: (n_read,) int32; out_operands: (n_out,)
// int32.  The form (k6_form in the wrapper): `lanes` (128, 64 or 32) a
// block; the slots [0, n_shared) in shared memory and, when n_shared <
// n_slots, the rest in `scratch`, which holds n_slots - n_shared slots of
// scratch_lanes lanes (a whole number of blocks); the bank in shared
// memory when bank_shared is nonzero, else read from `bank`.
// The kernel without the spilling checks runs when every slot and the
// bank are in shared memory.
extern "C" int plk_constraint_program(const void* in, void* out, const void* ops, int n_ops,
                                      const void* bank, int bank_size, const void* input_slot,
                                      const void* out_operands, int n_out, int n_slots,
                                      int n_shared, int lanes, int bank_shared,
                                      void* scratch, long long scratch_lanes, long long C,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_slots < 0 || n_ops < 0 || n_out < 0 || bank_size < 0 || n_shared < 0 ||
      n_shared > n_slots || (lanes != 128 && lanes != 64 && lanes != 32))
    return (int)cudaErrorInvalidValue;
  if (C == 0) return 0;
  const int64_t slot_bytes = (int64_t)8 * n_shared * lanes;
  const bool spill = n_shared < n_slots || !bank_shared;
  const int64_t smem = slot_bytes + (bank_shared ? (int64_t)8 * bank_size : 0);
  if (smem > MAX_SHARED) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (C + lanes - 1) / lanes;
  int64_t blocks = tiles;
  if (n_shared < n_slots) {
    if (scratch == nullptr || scratch_lanes < lanes || scratch_lanes % lanes)
      return (int)cudaErrorInvalidValue;
    blocks = tiles < scratch_lanes / lanes ? tiles : scratch_lanes / lanes;
  }
  const void* fn = spill ? (const void*)linear_program_kernel<true>
                         : (const void*)linear_program_kernel<false>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (spill)
    linear_program_kernel<true><<<(unsigned)blocks, lanes, (size_t)smem, st>>>(
        (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)ops, n_ops, (const uint64_t*)bank,
        bank_size, bank_shared, (const int*)input_slot, (const int*)out_operands, n_out,
        n_shared, (uint64_t*)scratch, (int64_t)scratch_lanes, (int64_t)C);
  else
    linear_program_kernel<false><<<(unsigned)blocks, lanes, (size_t)smem, st>>>(
        (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)ops, n_ops, (const uint64_t*)bank,
        bank_size, true, (const int*)input_slot, (const int*)out_operands, n_out, n_shared,
        nullptr, 0, (int64_t)C);
  return (int)cudaGetLastError();
}
