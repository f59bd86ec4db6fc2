// Kernels K3 and K5: radix-2 NTTs down the columns of a (B, n1, n2) batch.
//
// K3 replaces plonky2_tpu/ops/ntt_pallas.py:ntt_cols_pallas (DIT, natural
// order in and out; the inverse swaps in inverse twiddles and does not scale
// by 1/n).  K5 replaces ntt_pallas.py:ntt_cols_dif_pallas (DIF, natural order
// in, bit-reversed order out, optional implied zero tail of n1 - q rows).
// Both compute what the TPU kernels compute; the roll/select butterflies and
// lane tiles were how the TPU did it.  The bit reversal that the JAX caller
// applies before ntt_cols_pallas happens here as the load's row index.
//
// Optional fused pointwise products (nullptr to skip), which the JAX package
// left to XLA between kernels: `pre` (q, n2) multiplies the input as it is
// loaded, `post` (n1, n2) multiplies the output as it is stored.  The four-
// step schedule puts the coset shift, the step-2 twiddles and the 1/n scale
// there, so they never make an extra pass over the matrix.
//
// Bound on an H100: HBM bytes (one 64x64 product per butterfly and
// log2(n1) stages is ~4 log2(n1) int32 multiplies per 16 bytes moved, below
// the card's int32-ops-per-byte line).  Design: one block per (batch, tile of
// T columns); the n1 x T tile and the n1 twiddles are staged in shared
// memory and every stage runs there, so each element is read from and
// written to HBM once.  T keeps n1 * T * 8 bytes near 64 KB.
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int THREADS = 256;

template <bool DIF>
__global__ void ntt_cols_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                                const uint64_t* __restrict__ twiddles,
                                const uint64_t* __restrict__ pre,
                                const uint64_t* __restrict__ post, int q, int log_n1,
                                int64_t n2, int log_t) {
  extern __shared__ uint64_t smem[];
  const int n1 = 1 << log_n1;
  const int T = 1 << log_t;
  uint64_t* tile = smem;          // n1 * T, row-major (row, column in tile)
  uint64_t* tw = smem + n1 * T;   // n1: stage s at [2^s - 1, 2^(s+1) - 1)
  const int64_t b = blockIdx.y;
  const int64_t j0 = (int64_t)blockIdx.x * T;
  const uint64_t* src = in + b * q * n2 + j0;
  uint64_t* dst = out + b * (int64_t)n1 * n2 + j0;

  for (int k = threadIdx.x; k < n1; k += blockDim.x) tw[k] = twiddles[k];
  for (int k = threadIdx.x; k < n1 * T; k += blockDim.x) {
    int i = k >> log_t, jj = k & (T - 1);
    uint64_t v = 0;
    if (i < q) {
      v = src[(int64_t)i * n2 + jj];
      if (pre) v = gl::mul(v, pre[(int64_t)i * n2 + j0 + jj]);
    }
    int row = i;
    if (!DIF && log_n1) row = (int)(__brev((unsigned)i) >> (32 - log_n1));
    tile[row * T + jj] = v;
  }
  __syncthreads();

  const int pairs = (n1 >> 1) * T;
  for (int step = 0; step < log_n1; step++) {
    const int s = DIF ? log_n1 - 1 - step : step;
    const int half = 1 << s;
    for (int k = threadIdx.x; k < pairs; k += blockDim.x) {
      int jj = k & (T - 1), p = k >> log_t;
      int i = p & (half - 1);
      int r0 = ((p >> s) << (s + 1)) + i;
      uint64_t* x0 = tile + r0 * T + jj;
      uint64_t* x1 = x0 + half * T;
      uint64_t w = tw[half - 1 + i];
      uint64_t u = *x0, v = *x1;
      if (DIF) {
        *x0 = gl::add(u, v);
        *x1 = gl::mul(gl::sub(u, v), w);
      } else {
        v = gl::mul(v, w);
        *x0 = gl::add(u, v);
        *x1 = gl::sub(u, v);
      }
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < n1 * T; k += blockDim.x) {
    int i = k >> log_t, jj = k & (T - 1);
    uint64_t v = tile[i * T + jj];
    if (post) v = gl::mul(v, post[(int64_t)i * n2 + j0 + jj]);
    dst[(int64_t)i * n2 + jj] = v;
  }
}

template <bool DIF>
int launch(const void* in, void* out, const void* twiddles, const void* pre, const void* post,
           long long B, long long q, int log_n1, long long n2, int log_t, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || n2 == 0) return 0;
  size_t smem = ((size_t)(1 << log_n1) * ((size_t)1 << log_t) + ((size_t)1 << log_n1)) *
                sizeof(uint64_t);
  err = cudaFuncSetAttribute(ntt_cols_kernel<DIF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(n2 >> log_t), (unsigned)B);
  ntt_cols_kernel<DIF><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)twiddles, (const uint64_t*)pre,
      (const uint64_t*)post, (int)q, log_n1, (int64_t)n2, log_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plk_ntt_cols_dit(const void* in, void* out, const void* twiddles, const void* pre,
                                const void* post, long long B, int log_n1, long long n2,
                                int log_t, int device, void* stream) {
  return launch<false>(in, out, twiddles, pre, post, B, 1LL << log_n1, log_n1, n2, log_t, device,
                       stream);
}

extern "C" int plk_ntt_cols_dif(const void* in, void* out, const void* twiddles, const void* pre,
                                const void* post, long long B, long long q, int log_n1,
                                long long n2, int log_t, int device, void* stream) {
  return launch<true>(in, out, twiddles, pre, post, B, q, log_n1, n2, log_t, device, stream);
}
