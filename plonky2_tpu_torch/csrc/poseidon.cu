// Kernels K1 and K2: the Poseidon-12 leaf sponge and one Merkle level.
//
// K1 replaces plonky2_tpu/hash/poseidon_pallas.py:hash_leaves_cols_pallas,
// K2 replaces plonky2_tpu/hash/poseidon_pallas.py:compress_pairs_cols_pallas.
// They compute what those compute (rate-8 overwrite absorb, 4 + 22 + 4
// rounds, x^7, circulant + diagonal MDS, canonical digest), not how: the
// TPU's int8 MXU planes and lane tiles have no counterpart here.
//
// Bound on an H100: integer operations.  A permutation needs ~6.7k 32x32
// multiplies on the fast partial-round schedule (sparse partial-round MDS;
// this kernel runs the plain schedule's ~10.5k: x^7 S-boxes as 64x64
// products, a 12x12 MDS on 32-bit halves every round) per 8 words of input,
// far above the card's int32 rate per byte of HBM, so memory is not the
// limit.  Design: one thread per leaf (K1) or
// node (K2); the 12-word state lives in registers; round constants and MDS
// sit in __constant__ memory (every thread of a warp reads the same word);
// a leaf's L words are a column of the (L, N) matrix, so neighbouring threads
// load neighbouring addresses.
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "poseidon_constants.h"  // generated at build time: PLK_RC, PLK_MDS

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl::mul_nc(x, x);
  uint64_t x3 = gl::mul_nc(x2, x);
  uint64_t x4 = gl::mul_nc(x2, x2);
  return gl::mul_nc(x3, x4);
}

// state <- M * state for any 64-bit representatives; results below 2^64.
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  uint32_t lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int c = 0; c < WIDTH; c++) {
    lo[c] = (uint32_t)s[c];
    hi[c] = (uint32_t)(s[c] >> 32);
  }
#pragma unroll
  for (int r = 0; r < WIDTH; r++) {
    uint64_t al = 0, ah = 0;
#pragma unroll
    for (int c = 0; c < WIDTH; c++) {
      uint32_t m = PLK_MDS[r * WIDTH + c];
      al += (uint64_t)m * lo[c];
      ah += (uint64_t)m * hi[c];
    }
    // al + ah * 2^32 as a 128-bit value (al, ah < 2^42)
    uint64_t low = al + (ah << 32);
    uint64_t high = (ah >> 32) + (low < al ? 1 : 0);
    s[r] = gl::reduce128(low, high);
  }
}

__device__ __forceinline__ void add_round_constants(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; i++) s[i] = gl::add_nc(s[i], PLK_RC[r * WIDTH + i]);
}

__device__ void permute(uint64_t s[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < 4; r++) {
    add_round_constants(s, r);
#pragma unroll
    for (int i = 0; i < WIDTH; i++) s[i] = sbox(s[i]);
    mds(s);
  }
#pragma unroll 1
  for (int r = 4; r < 26; r++) {
    add_round_constants(s, r);
    s[0] = sbox(s[0]);
    mds(s);
  }
#pragma unroll 1
  for (int r = 26; r < 30; r++) {
    add_round_constants(s, r);
#pragma unroll
    for (int i = 0; i < WIDTH; i++) s[i] = sbox(s[i]);
    mds(s);
  }
}

__global__ void hash_leaves_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                   int64_t L, int64_t N) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) s[j] = 0;
  int64_t full = L / RATE;
  int rem = (int)(L % RATE);
  for (int64_t k = 0; k < full; k++) {
    const uint64_t* col = in + k * RATE * N + i;
#pragma unroll
    for (int j = 0; j < RATE; j++) s[j] = col[j * N];
    permute(s);
  }
  if (rem) {
    const uint64_t* col = in + full * RATE * N + i;
#pragma unroll
    for (int j = 0; j < RATE; j++)
      if (j < rem) s[j] = col[j * N];
    permute(s);
  }
#pragma unroll
  for (int j = 0; j < 4; j++) out[j * N + i] = gl::canon(s[j]);
}

// in: (4, 2m) level, node pairs (2i, 2i+1) adjacent; out: (4, m) parents.
__global__ void compress_level_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                      int64_t m) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < 4; j++) {
    s[j] = in[j * 2 * m + 2 * i];
    s[4 + j] = in[j * 2 * m + 2 * i + 1];
    s[8 + j] = 0;
  }
  permute(s);
#pragma unroll
  for (int j = 0; j < 4; j++) out[j * m + i] = gl::canon(s[j]);
}

constexpr int THREADS = 128;

}  // namespace

extern "C" int plk_hash_leaves(const void* in, void* out, long long L, long long N, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return 0;
  unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  hash_leaves_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (int64_t)L, (int64_t)N);
  return (int)cudaGetLastError();
}

extern "C" int plk_compress_level(const void* in, void* out, long long m, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m == 0) return 0;
  unsigned blocks = (unsigned)((m + THREADS - 1) / THREADS);
  compress_level_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (int64_t)m);
  return (int)cudaGetLastError();
}

extern "C" const char* plk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
