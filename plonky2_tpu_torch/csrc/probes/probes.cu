// Measurement probes for chip_smoke.py; no main path runs them.
//
// mul_rate_kernel: the card's issue rate of independent 32x32 multiplies,
// as mad.lo.u32 (one IMAD), mad.wide.u32 (32x32 -> 64 plus a 64-bit
// addend, one IMAD.WIDE.U32: what goldilocks.cuh's field product and
// Poseidon's MDS are made of), mul.wide.u32 (no addend) and mad.hi.u32.
// Each thread runs CHAINS independent dependency chains, so that latency
// hides behind the other chains and warps.  The operation bounds of K1, K2
// and K6 assume 64 products a clock an SM.
//
// field_*_probe: one field product a thread, for counting the multiply
// instructions of one product in the SASS: goldilocks.cuh's mul_nc and
// mul_nc_split, the form they replaced (a * b and __umul64hi, then the same reduce128), and a
// baseline that does no product (address arithmetic only).
#include <cuda_runtime.h>

#include "../goldilocks.cuh"

namespace {

constexpr int CHAINS = 8;

// Each thread runs CHAINS chains of one instruction for `iters` steps.
template <int MODE>
__global__ void mul_rate_kernel(uint64_t* out, int iters) {
  const uint32_t m = 2 * threadIdx.x + 1;
  uint64_t acc[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; j++) acc[j] = j + threadIdx.x;
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int j = 0; j < CHAINS; j++) {
      if (MODE == 0) {  // mad.lo.u32: one IMAD
        uint32_t a = (uint32_t)acc[j];
        asm volatile("mad.lo.u32 %0, %0, %1, %0;" : "+r"(a) : "r"(m));
        acc[j] = a;
      } else if (MODE == 1) {  // mad.wide.u32 with a 64-bit addend
        asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(acc[j]) : "r"((uint32_t)acc[j]), "r"(m));
      } else if (MODE == 2) {  // mul.wide.u32, no addend
        asm volatile("mul.wide.u32 %0, %1, %2;" : "=l"(acc[j]) : "r"((uint32_t)acc[j] ^ m), "r"(m));
      } else {  // mad.hi.u32
        uint32_t a = (uint32_t)acc[j];
        asm volatile("mad.hi.u32 %0, %0, %1, %0;" : "+r"(a) : "r"(m));
        acc[j] = a;
      }
    }
  }
  uint64_t x = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; j++) x ^= acc[j];
  out[(int64_t)blockIdx.x * blockDim.x + threadIdx.x] = x;
}

}  // namespace

__global__ void field_mul_probe(const uint64_t* a, const uint64_t* b, uint64_t* out) {
  out[threadIdx.x] = gl::mul_nc(a[threadIdx.x], b[threadIdx.x]);
}

__global__ void field_mul_split_probe(const uint64_t* a, const uint64_t* b, uint64_t* out) {
  out[threadIdx.x] = gl::mul_nc_split(a[threadIdx.x], b[threadIdx.x]);
}

__global__ void field_mul_umul64hi_probe(const uint64_t* a, const uint64_t* b, uint64_t* out) {
  const uint64_t x = a[threadIdx.x], y = b[threadIdx.x];
  out[threadIdx.x] = gl::reduce128(x * y, __umul64hi(x, y));
}

__global__ void field_baseline_probe(const uint64_t* a, const uint64_t* b, uint64_t* out) {
  out[threadIdx.x] = a[threadIdx.x] ^ b[threadIdx.x];
}

// out: blocks * threads words.  mode: 0 mad.lo.u32, 1 mad.wide.u32 (64-bit
// addend), 2 mul.wide.u32, 3 mad.hi.u32.  Instructions issued: blocks *
// threads * CHAINS * iters.
extern "C" int plk_probe_mul_rate(void* out, int blocks, int threads, int iters, int mode,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  uint64_t* o = (uint64_t*)out;
  if (mode == 0) mul_rate_kernel<0><<<blocks, threads, 0, s>>>(o, iters);
  else if (mode == 1) mul_rate_kernel<1><<<blocks, threads, 0, s>>>(o, iters);
  else if (mode == 2) mul_rate_kernel<2><<<blocks, threads, 0, s>>>(o, iters);
  else mul_rate_kernel<3><<<blocks, threads, 0, s>>>(o, iters);
  return (int)cudaGetLastError();
}

extern "C" int plk_probe_chains() { return CHAINS; }
