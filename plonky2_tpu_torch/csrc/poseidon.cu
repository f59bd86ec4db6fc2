// Kernels K1 and K2: the Poseidon-12 leaf sponge and the Merkle levels;
// K7, K9 and K8 (at the end), which no TPU kernel has: the Poseidon gate's
// witness waves, the transcript's sponge and the FRI proof-of-work grind.
//
// K1 replaces plonky2_tpu/hash/poseidon_pallas.py:hash_leaves_cols_pallas,
// K2 replaces plonky2_tpu/hash/poseidon_pallas.py:compress_pairs_cols_pallas
// in two forms: one launch a wide level (compress_level_kernel) and one
// launch for the narrow top of a tree (compress_tail_kernel, below).
// They compute what those compute (rate-8 overwrite absorb, 4 + 22 + 4
// rounds, x^7, circulant + diagonal MDS, canonical digest), not how: the
// TPU's int8 MXU planes and lane tiles have no counterpart here.
//
// Bound on an H100 (K1, and K2 on a wide level): integer operations.  A
// permutation needs ~4.1k 32x32 products on the integer pipe and 2.3k
// float64 multiply-adds (the full rounds' MDS) on the FP64 pipe, on the
// fast partial-round schedule, which this kernel runs as the TPU kernel
// and plonky2_tpu/hash/poseidon.py:poseidon_ints do: 4 full rounds; the
// first partial-round constant and the dense 11x11 initial matrix; 22
// partial rounds, each an S-box on s[0] and a sparse layer (d = 25 s0 +
// sum w_hat[r][i] s[i], s[i] += s0 v[r][i]); 4 full rounds.  That is far
// above the card's int32 rate per byte of HBM, so memory is not the limit.
//
// Design: one thread per leaf (K1) or node (K2 on a wide level; the narrow
// top's design is below); the 12-word state lives in registers; all
// tables sit in __constant__ memory (every thread of a warp
// reads the same word); a leaf's L words are a column of the (L, N)
// matrix, so neighbouring threads load neighbouring addresses.  A thread
// has many independent products in flight (twelve S-boxes a full round,
// eleven dot terms a partial one), so it takes goldilocks.cuh's forms that
// issue fastest (mul_wide_split, square_wide_split, reduce128_cc).
// Full rounds run the small-coefficient MDS in exact float64 (mds).  The
// sparse and initial layers' dot products add their 128-bit products into
// one 160-bit accumulator (dot_*), reduced once per output.
// __launch_bounds__(128, 1) lets a thread take 255 registers (two blocks
// an SM); without the 1, or with 3 (168 registers), ptxas spills and the
// kernel runs 9-17% slower (PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "goldilocks.cuh"
#include "poseidon_constants.h"  // generated at build time: PLK_RC, PLK_MDS_F64, PLK_FAST_*

namespace {

constexpr int WIDTH = 12;
constexpr int RATE = 8;
constexpr int THREADS = 128;

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl::square_nc_split(x);
  uint64_t x3 = gl::mul_nc_split(x2, x);
  uint64_t x4 = gl::square_nc_split(x2);
  return gl::mul_nc_split(x3, x4);
}

// (al, ah) = sum_c M[r][c] * (lo[c], hi[c]) -> state word r, below 2^64.
__device__ __forceinline__ uint64_t mds_combine(uint64_t al, uint64_t ah) {
  // al + ah * 2^32 as a 128-bit value (al, ah < 2^42)
  uint64_t low = al + (ah << 32);
  uint64_t high = (ah >> 32) + (low < al ? 1 : 0);
  return gl::reduce128_cc(low, high);
}

// state <- M * state for any 64-bit representatives; results below 2^64.
// The small coefficients multiply the 32-bit halves in float64 on the FP64
// pipe, which nothing else uses: halves, products and sums are integers
// below 2^53, so every DFMA is exact.  2^52 + x has x in its low mantissa
// bits, which converts both ways with one DADD and one logic op.  (As
// 64-bit integer multiply-adds, IMAD.WIDE.U32 with a 64-bit addend, the
// kernel took 6% longer: PERF.md.)
constexpr double TWO52 = 4503599627370496.0;

__device__ __forceinline__ double u32_to_f64(uint32_t x) {
  return __longlong_as_double(0x4330000000000000ll | (long long)x) - TWO52;
}

__device__ __forceinline__ uint64_t f64_to_u64(double d) {  // integral, 0 <= d < 2^52
  return (uint64_t)__double_as_longlong(d + TWO52) & 0xFFFFFFFFFFFFFull;
}

__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  double lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int c = 0; c < WIDTH; c++) {
    lo[c] = u32_to_f64((uint32_t)s[c]);
    hi[c] = u32_to_f64((uint32_t)(s[c] >> 32));
  }
#pragma unroll
  for (int r = 0; r < WIDTH; r++) {
    double al = 0, ah = 0;
#pragma unroll
    for (int c = 0; c < WIDTH; c++) {
      const double m = PLK_MDS_F64[r * WIDTH + c];
      al = fma(m, lo[c], al);
      ah = fma(m, hi[c], ah);
    }
    s[r] = mds_combine(f64_to_u64(al), f64_to_u64(ah));
  }
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; i++) s[i] = sbox(gl::add_nc(s[i], PLK_RC[r * WIDTH + i]));
  mds(s);
}

// A sum of up to 2^32 128-bit products as 160 bits: five 32-bit limbs,
// little end first, added with one carry chain per product.
struct Dot {
  uint32_t w[5];
};

__device__ __forceinline__ void dot_init(Dot& d, uint64_t lo, uint64_t hi) {
  d.w[0] = (uint32_t)lo;
  d.w[1] = (uint32_t)(lo >> 32);
  d.w[2] = (uint32_t)hi;
  d.w[3] = (uint32_t)(hi >> 32);
  d.w[4] = 0;
}

// d += a * b for any 64-bit a, b.
__device__ __forceinline__ void dot_add(Dot& d, uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  gl::mul_wide_split(a, b, lo, hi);
  asm("{\n\t.reg .u32 l0, l1, h0, h1;\n\t"
      "mov.b64 {l0, l1}, %5;\n\t"
      "mov.b64 {h0, h1}, %6;\n\t"
      "add.cc.u32 %0, %0, l0;\n\t"
      "addc.cc.u32 %1, %1, l1;\n\t"
      "addc.cc.u32 %2, %2, h0;\n\t"
      "addc.cc.u32 %3, %3, h1;\n\t"
      "addc.u32 %4, %4, 0;\n\t}"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]), "+r"(d.w[4])
      : "l"(lo), "l"(hi));
}

// The sum mod p as a representative below 2^64: 2^128 == -2^32 (mod p),
// and the top limb (a count of carries) times 2^32 stays far below p.
__device__ __forceinline__ uint64_t dot_reduce(const Dot& d) {
  uint64_t lo = ((uint64_t)d.w[1] << 32) | d.w[0];
  uint64_t hi = ((uint64_t)d.w[3] << 32) | d.w[2];
  uint64_t r = gl::reduce128_cc(lo, hi);
  uint64_t t = (uint64_t)d.w[4] << 32;
  uint64_t out = r - t;
  return r < t ? out - gl::EPS : out;
}

// Partial round r of the fast schedule (plonky2 mds_partial_layer_fast).
__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int r) {
  // the constant after the S-box is 0 in the last round
  const uint64_t s0 = gl::add_nc(sbox(s[0]), PLK_FAST_PRC[r]);
  Dot d;
  uint64_t lo, hi;
  gl::mul_wide_split(s0, PLK_FAST_MS0, lo, hi);
  dot_init(d, lo, hi);
#pragma unroll
  for (int i = 1; i < WIDTH; i++) dot_add(d, s[i], PLK_FAST_WHAT[r * 11 + i - 1]);
#pragma unroll
  for (int i = 1; i < WIDTH; i++) {
    // s[i] + s0 * v < 2^128, reduced once.  The product in the addend
    // form: its multiply-pipe cycles balance the dot products'
    // integer-ALU ones (2% faster, PERF.md).
    gl::mul_wide(s0, PLK_FAST_VS[r * 11 + i - 1], lo, hi);
    lo += s[i];
    hi += lo < s[i] ? 1 : 0;
    s[i] = gl::reduce128_cc(lo, hi);
  }
  s[0] = dot_reduce(d);
}

// The first partial-round constant, then the initial matrix (row and
// column 0 pass s[0] through): the state the 22 partial rounds start from.
__device__ __forceinline__ void initial_layer(uint64_t s[WIDTH]) {
#pragma unroll
  for (int i = 0; i < WIDTH; i++) s[i] = gl::add_nc(s[i], PLK_FAST_FIRST[i]);
  uint64_t t[WIDTH];
  t[0] = s[0];
#pragma unroll
  for (int c = 1; c < WIDTH; c++) {
    Dot d;
    dot_init(d, 0, 0);
#pragma unroll
    for (int r = 1; r < WIDTH; r++) dot_add(d, s[r], PLK_FAST_INIT[(r - 1) * 11 + c - 1]);
    t[c] = dot_reduce(d);
  }
#pragma unroll
  for (int i = 0; i < WIDTH; i++) s[i] = t[i];
}

__device__ void permute(uint64_t s[WIDTH]) {
#pragma unroll 1
  for (int r = 0; r < 4; r++) full_round(s, r);
  initial_layer(s);
#pragma unroll 1
  for (int r = 0; r < 22; r++) partial_round(s, r);
#pragma unroll 1
  for (int r = 26; r < 30; r++) full_round(s, r);
}

__global__ void __launch_bounds__(THREADS, 1)
hash_leaves_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t L,
                   int64_t N) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) s[j] = 0;
  // rate-8 blocks overwrite rows [0, 8); a last block of w < 8 rows
  // overwrites rows [0, w).  One call site keeps one copy of permute.
  for (int64_t k = 0; k * RATE < L; k++) {
    const uint64_t* col = in + k * RATE * N + i;
    const int64_t w = L - k * RATE;
#pragma unroll
    for (int j = 0; j < RATE; j++)
      if (j < w) s[j] = col[j * N];
    permute(s);
  }
#pragma unroll
  for (int j = 0; j < 4; j++) out[j * N + i] = gl::canon(s[j]);
}

// in: (4, 2m) level, node pairs (2i, 2i+1) adjacent; out: (4, m) parents.
__global__ void __launch_bounds__(THREADS, 1)
compress_level_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out, int64_t m) {
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


// ---------------------------------------------------------------------------
// K2's narrow top: every level from m0 parents down to the cap in one launch.
//
// Bound: latency, not operations.  A level of m <= 2^14 parents is a few
// thousand permutations, far too few to fill the card, so a level takes as
// long as one permutation's dependent chain, and the levels depend on each
// other.  One thread a node (compress_level_kernel) takes ~0.049 ms a level
// on an H100, device time, whether m is 32 or 2^14 (PERF.md, K2).
//
// Design: (1) one persistent cooperative launch walks all the levels, a
// grid-wide barrier between two levels (no launch gap, no host between
// them); the grid is as many blocks as fit the card at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), fewer when the widest
// level needs fewer, and a grid-stride loop covers the rest.  (2) One
// permutation is split across a group of TAIL_LANES (g) lanes of a warp:
// lane l keeps state words l, l + g, l + 2g, ...  A full round runs each
// lane's own S-boxes, gathers the other words with __shfl_sync and
// computes the lane's own rows of the float64 MDS.  A partial round keeps
// s0 in every lane: each lane sums its own w_hat terms into a 160-bit Dot,
// the group merges the Dots with an xor butterfly of limb shuffles (added
// with carries, reduced once), and every lane runs the S-box on s0 itself,
// so no broadcast sits on the chain.  The w_hat sums and their merge do
// not depend on the round's S-box and overlap it.  The S-boxes take K1's
// forms (the latency forms, mul_nc, measured 6% slower).  Tables indexed
// by a lane's own word sit in shared memory, word index fastest, so a
// warp's lanes read distinct banks (__constant__ would serialize distinct
// addresses).  Each level reads its input through L2 (ld.global.cg): other
// blocks wrote it in this launch.  tests/test_torch_poseidon.py models this
// schedule (lanes as an array axis, shuffles as gathers) against
// permute_ints.
//
// Measured on an H100 at 700 W (PERF.md, K2; scripts/
// port_merkle_tail_variants.py, chip_smoke.py phase 3b): a 2^21-leaf
// tree's 11 levels of 2^14 down to 16 parents take 0.36 ms here against
// 0.56 ms as 11 launches.  g = 4 over those 11 levels: 0.360 ms; g = 2
// 0.377; g = 16 0.516 (one level of 16-2^10 parents 0.023 ms against g =
// 4's 0.029, but 2^13 and 2^14 parents need 16 lanes a node and take 0.10
// and 0.15 ms).  A lone g = 4 permutation is ~36k cycles (clock64), 67% of
// them the 22 partial rounds, whose S-box and reduction form one serial
// chain.  Block barriers in place of the grid barriers on the top six
// levels gain nothing (0.3600 against 0.3606 ms).  T = 2^14
// (hash/merkle_torch.py:TAIL_PARENTS) against 2^15 and 2^16: 0.57, 0.59
// and 0.63 ms for the 13 levels above 2^17 nodes.
constexpr int TAIL_LANES = 4;
constexpr int TAIL_THREADS = 128;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct TailTables {
  uint64_t rc[8][WIDTH];       // full rounds 0-3 and 26-29
  double mds[WIDTH][WIDTH];    // [c][r] = M[r][c]
  uint64_t first[WIDTH];
  uint64_t init[11][11];       // [r - 1][c - 1], as PLK_FAST_INIT
  uint64_t what[22][11];       // [round][i - 1]
  uint64_t vs[22][11];
};

__device__ void load_tail_tables(TailTables& t) {
  for (int i = threadIdx.x; i < 8 * WIDTH; i += blockDim.x) {
    const int r = i / WIDTH;
    t.rc[r][i % WIDTH] = PLK_RC[(r < 4 ? r : r + 22) * WIDTH + i % WIDTH];
  }
  for (int i = threadIdx.x; i < WIDTH * WIDTH; i += blockDim.x)
    t.mds[i % WIDTH][i / WIDTH] = PLK_MDS_F64[i];
  for (int i = threadIdx.x; i < WIDTH; i += blockDim.x) t.first[i] = PLK_FAST_FIRST[i];
  for (int i = threadIdx.x; i < 121; i += blockDim.x) t.init[i / 11][i % 11] = PLK_FAST_INIT[i];
  for (int i = threadIdx.x; i < 242; i += blockDim.x) {
    t.what[i / 11][i % 11] = PLK_FAST_WHAT[i];
    t.vs[i / 11][i % 11] = PLK_FAST_VS[i];
  }
}

// d += e, both 160-bit Dots (the sum of a node's products stays below 2^133).
__device__ __forceinline__ void dot_merge(Dot& d, const uint32_t e[5]) {
  asm("add.cc.u32 %0, %0, %5;\n\t"
      "addc.cc.u32 %1, %1, %6;\n\t"
      "addc.cc.u32 %2, %2, %7;\n\t"
      "addc.cc.u32 %3, %3, %8;\n\t"
      "addc.u32 %4, %4, %9;"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]), "+r"(d.w[4])
      : "r"(e[0]), "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]));
}

// The permutation of one state spread over a group of G lanes: slot k of
// lane l holds word l + G k (K slots; words past 11 are unused).
template <int G>
struct LaneState {
  static constexpr int K = (WIDTH + G - 1) / G;
  uint64_t s[K];
};

template <int G>
__device__ __forceinline__ uint64_t group_word(const LaneState<G>& st, int w) {
  return __shfl_sync(FULL_MASK, st.s[w / G], w % G, G);
}

// What permute_lanes records of a permutation: a full round's state after
// its constant layer (round r of the eight, word w) and a partial round's
// s0 before its S-box.  K2 records nothing (the calls inline to nothing);
// K7 records its gate's wires (WireRecorder, below).
struct NoRecord {
  __device__ __forceinline__ void full(int, int, uint64_t) const {}
  __device__ __forceinline__ void partial(int, uint64_t) const {}
};

template <int G, class Rec>
__device__ __forceinline__ void full_round_lanes(LaneState<G>& st, int lane, int r,
                                                 const TailTables& t, const Rec& rec) {
  constexpr int K = LaneState<G>::K;
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int w = lane + G * k;
    if (w < WIDTH) {
      const uint64_t x = gl::add_nc(st.s[k], t.rc[r][w]);
      rec.full(r, w, x);
      st.s[k] = sbox(x);
    }
  }
  double lo[WIDTH], hi[WIDTH];
#pragma unroll
  for (int c = 0; c < WIDTH; c++) {
    const uint64_t x = group_word(st, c);
    lo[c] = u32_to_f64((uint32_t)x);
    hi[c] = u32_to_f64((uint32_t)(x >> 32));
  }
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int w = lane + G * k;
    if (w < WIDTH) {
      double al = 0, ah = 0;
#pragma unroll
      for (int c = 0; c < WIDTH; c++) {
        al = fma(t.mds[c][w], lo[c], al);
        ah = fma(t.mds[c][w], hi[c], ah);
      }
      st.s[k] = mds_combine(f64_to_u64(al), f64_to_u64(ah));
    }
  }
}

template <int G, class Rec = NoRecord>
__device__ void permute_lanes(LaneState<G>& st, int lane, const TailTables& t,
                              const Rec& rec = Rec()) {
  constexpr int K = LaneState<G>::K;
#pragma unroll 1
  for (int r = 0; r < 4; r++) full_round_lanes(st, lane, r, t, rec);
  // first partial-round constant, then the initial matrix over words 1-11
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int w = lane + G * k;
    if (w < WIDTH) st.s[k] = gl::add_nc(st.s[k], t.first[w]);
  }
  uint64_t x[WIDTH];
#pragma unroll
  for (int c = 0; c < WIDTH; c++) x[c] = group_word(st, c);
#pragma unroll
  for (int k = 0; k < K; k++) {
    const int w = lane + G * k;
    if (w > 0 && w < WIDTH) {
      Dot d;
      dot_init(d, 0, 0);
#pragma unroll
      for (int i = 1; i < WIDTH; i++) dot_add(d, x[i], t.init[i - 1][w - 1]);
      st.s[k] = dot_reduce(d);
    }
  }
  uint64_t s0 = x[0];  // every lane keeps s0 through the partial rounds
#pragma unroll 1
  for (int r = 0; r < 22; r++) {
    Dot d;
    dot_init(d, 0, 0);
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int w = lane + G * k;
      if (w > 0 && w < WIDTH) dot_add(d, st.s[k], t.what[r][w - 1]);
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      uint32_t e[5];
#pragma unroll
      for (int j = 0; j < 5; j++) e[j] = __shfl_xor_sync(FULL_MASK, d.w[j], o, G);
      dot_merge(d, e);
    }
    rec.partial(r, s0);
    // the constant after the S-box is 0 in the last round
    const uint64_t x0 = gl::add_nc(sbox(s0), PLK_FAST_PRC[r]);
    uint64_t lo, hi;
    gl::mul_wide(x0, PLK_FAST_MS0, lo, hi);
    uint32_t e[5] = {(uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32), 0};
    dot_merge(d, e);
#pragma unroll
    for (int k = 0; k < K; k++) {
      const int w = lane + G * k;
      if (w > 0 && w < WIDTH) {
        gl::mul_wide(x0, t.vs[r][w - 1], lo, hi);
        lo += st.s[k];
        hi += lo < st.s[k] ? 1 : 0;
        st.s[k] = gl::reduce128(lo, hi);
      }
    }
    s0 = dot_reduce(d);
  }
  if (lane == 0) st.s[0] = s0;
#pragma unroll 1
  for (int r = 4; r < 8; r++) full_round_lanes(st, lane, r, t, rec);
}

// in: (4, 2 m0), node pairs adjacent; out: the n_levels levels of m0,
// m0 / 2, ... parents, each (4, m) row-major, one after the other.
template <int G>
__global__ void __launch_bounds__(TAIL_THREADS, 4)
compress_tail_kernel(const uint64_t* in, uint64_t* out, int64_t m0, int n_levels) {
  constexpr int K = LaneState<G>::K;
  constexpr int NODES_PER_WARP = 32 / G;
  __shared__ TailTables t;
  load_tail_tables(t);
  __syncthreads();
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int lane = threadIdx.x % G;
  const int group = (threadIdx.x % 32) / G;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int64_t n_warps = (int64_t)gridDim.x * blockDim.x / 32;
  const uint64_t* src = in;
  uint64_t* dst = out;
  int64_t m = m0;
  for (int level = 0; level < n_levels; level++) {
    // warp-uniform bounds: every lane of a warp reaches every shuffle
    for (int64_t base = warp * NODES_PER_WARP; base < m; base += n_warps * NODES_PER_WARP) {
      const int64_t node = base + group;
      const int64_t i = node < m ? node : m - 1;
      LaneState<G> st;
#pragma unroll
      for (int k = 0; k < K; k++) {
        // words 0-3 the left child, 4-7 the right one, 8-11 zero
        const int w = lane + G * k;
        st.s[k] = w < 8 ? (uint64_t)__ldcg((const unsigned long long*)(
                              src + (w & 3) * 2 * m + 2 * i + (w >> 2)))
                        : 0;
      }
      permute_lanes(st, lane, t);
#pragma unroll
      for (int k = 0; k < K; k++) {
        const int w = lane + G * k;
        if (w < 4 && node < m) dst[w * m + node] = gl::canon(st.s[k]);
      }
    }
    if (level + 1 < n_levels) grid.sync();
    src = dst;
    dst += 4 * m;
    m >>= 1;
  }
}

// ---------------------------------------------------------------------------
// K7: the Poseidon gate's witness waves (port-only).  The JAX package
// computes a wave in XLA, with no Pallas kernel (plonky2_tpu/hash/
// poseidon_wires_jax.py:poseidon_wire_batch); the plain version here is
// hash/poseidon_wires.py:poseidon_wires_waves.  A launch runs a run of
// consecutive waves of the device witness plan: wave v is the columns
// [offsets[v], offsets[v + 1]) of the run's (13, R) and (122, R) int32
// index arrays.  Row g reads its 12 inputs and its swap wire from the slot
// buffer at dep_idx[k * R + g] (neighbouring rows, neighbouring indices),
// runs the permutation and writes the gate's 122 other wires at
// out_idx[k * R + g], in PoseidonGenerator.output_targets' order: 4 deltas,
// the S-box inputs of full rounds 1-3 (36), of the 22 partial rounds and
// of the last 4 full rounds (48), then the 12 outputs.  A swap wire that is
// not 0 or 1 sets *err (the plan raises).  Within a wave no row reads a
// slot that another row writes; a wave reads what the waves before it
// wrote.
//
// Bound on an H100: latency.  The flagship's plan runs 18 Poseidon waves
// of 2^16 rows down to 1, each reading the one before, so its floor is 18
// permutations one after the other; only the widest waves hold enough rows
// to fill the card (K1's ~4.1k products a row against ~1.6 kB of gathers,
// scatters and indices: integer operations there).  One launch a wave and
// one thread a row, the kernel's first form, took 1.475 ms for the 18,
// 23x the bytes (PERF.md).
//
// Design: K2's narrow top, reused.  (1) One persistent cooperative launch
// walks the run's waves with a grid-wide barrier between two waves; the
// grid is as many blocks as fit the card at once, fewer when the widest
// wave needs fewer, and a grid-stride loop covers the rest.  Reads of the
// slot buffer go through L2 (ld.global.cg): other blocks wrote them in this
// launch.  (2) One row's permutation is split across TAIL_LANES = 4 lanes
// (permute_lanes): lane l holds words l, l + 4 and l + 8, so it computes
// its own delta, swap * (s[l + 4] - s[l]), and its own swap without a
// shuffle, records its own words' S-box inputs of the full rounds and its
// own outputs, and lane 0 records the partial rounds' s0 (every lane holds
// s0).  Every recorded value goes through gl::canon (a witness wire; the
// rounds keep non-canonical intermediates).  Each of the 122 wires has
// exactly one writer lane (tests/test_torch_poseidon.py models the map).
// (3) A row's 122 slot indices are loaded into shared memory, all at once,
// before its permutation: a store waits for its index, and with each index
// read from global memory at its store, lane 0's 47 stores put ~47 memory
// latencies on the row's chain.  Measured on an H100 at 700 W (PERF.md):
// a narrow wave alone 0.048 -> 0.030 ms, the flagship's 18 waves in one
// launch 1.11 -> 0.89 ms on a session proof; one permutation over four
// lanes, as a one-row wave alone, 0.029 ms, so their floor is 0.53 ms.
constexpr int WIRE_OUTPUTS = 122;
constexpr int WIRE_STRIDE = 124;  // a row's indices in shared memory: 124 = 28 (mod 32)
                                  // puts the eight rows of a warp on distinct banks

struct WireRecorder {
  uint64_t* values;
  const int32_t* slot;  // the row's slot indices, in shared memory
  int lane;
  bool active;  // false on the grid-stride loop's padding rows

  __device__ __forceinline__ void put(int k, uint64_t v) const {
    if (active) values[slot[k]] = v;
  }
  // full rounds 1-3 (r = 1..3) and the last four (r = 4..7); round 0's
  // inputs are the gate's own input wires
  __device__ __forceinline__ void full(int r, int w, uint64_t x) const {
    if (r > 0) put((r < 4 ? 4 + WIDTH * (r - 1) : 62 + WIDTH * (r - 4)) + w, gl::canon(x));
  }
  __device__ __forceinline__ void partial(int r, uint64_t s0) const {
    if (lane == 0) put(40 + r, gl::canon(s0));
  }
};

template <int G>
__global__ void __launch_bounds__(TAIL_THREADS, 4)
poseidon_waves_kernel(uint64_t* values, const int32_t* __restrict__ dep_idx,
                      const int32_t* __restrict__ out_idx, const int64_t* __restrict__ offsets,
                      int n_waves, int64_t R, int* err) {
  static_assert(G == 4, "a lane holds words l, l + 4 and l + 8");
  constexpr int ROWS_PER_WARP = 32 / G;
  constexpr int PER_LANE = (WIRE_OUTPUTS + G - 1) / G;
  __shared__ TailTables t;
  __shared__ int32_t slots[TAIL_THREADS / G][WIRE_STRIDE];
  load_tail_tables(t);
  __syncthreads();
  int32_t* slot = slots[threadIdx.x / G];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int lane = threadIdx.x % G;
  const int group = (threadIdx.x % 32) / G;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int64_t n_warps = (int64_t)gridDim.x * blockDim.x / 32;
  for (int v = 0; v < n_waves; v++) {
    const int64_t first = offsets[v], m = offsets[v + 1] - first;
    // warp-uniform bounds: every lane of a warp reaches every shuffle
    for (int64_t base = warp * ROWS_PER_WARP; base < m; base += n_warps * ROWS_PER_WARP) {
      const int64_t row = base + group;
      const int64_t g = first + (row < m ? row : m - 1);
      int32_t in_slot[LaneState<G>::K + 1], out_slot[PER_LANE];
#pragma unroll
      for (int k = 0; k < LaneState<G>::K; k++) in_slot[k] = dep_idx[(lane + G * k) * R + g];
      in_slot[LaneState<G>::K] = dep_idx[WIDTH * R + g];
#pragma unroll
      for (int j = 0; j < PER_LANE; j++)
        if (lane + G * j < WIRE_OUTPUTS) out_slot[j] = out_idx[(lane + G * j) * R + g];
      __syncwarp();  // the group has finished with its previous row's slots
#pragma unroll
      for (int j = 0; j < PER_LANE; j++)
        if (lane + G * j < WIRE_OUTPUTS) slot[lane + G * j] = out_slot[j];
      LaneState<G> st;
#pragma unroll
      for (int k = 0; k < LaneState<G>::K; k++)
        st.s[k] = (uint64_t)__ldcg((const unsigned long long*)(values + in_slot[k]));
      const uint64_t swap =
          (uint64_t)__ldcg((const unsigned long long*)(values + in_slot[LaneState<G>::K]));
      if (swap > 1) *err = 1;
      __syncwarp();
      const WireRecorder rec{values, slot, lane, row < m};
      rec.put(lane, gl::mul(swap, gl::sub(st.s[1], st.s[0])));
      if (swap == 1) {
        const uint64_t x = st.s[0];
        st.s[0] = st.s[1];
        st.s[1] = x;
      }
      permute_lanes(st, lane, t, rec);
#pragma unroll
      for (int k = 0; k < LaneState<G>::K; k++)
        rec.put(WIRE_OUTPUTS - WIDTH + lane + G * k, gl::canon(st.s[k]));
    }
    if (v + 1 < n_waves) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// K9: the Fiat-Shamir transcript's duplex sponge (port-only).  The JAX
// package runs its device transcript in XLA, with no Pallas kernel
// (plonky2_tpu/iop/challenger_jax.py:DeviceChallenger); the plain version
// here is hash/poseidon_cuda.py:sponge, and iop/challenger_torch.py:
// DeviceChallenger issues one launch for each group of observations and
// draws.  buf holds the sponge: the 12 state words, then the pending
// inputs (8 slots, n_in of them in use); the outputs are the state's
// first n_out words, as the host challenger's always are.  The lengths
// are the caller's: the transcript's shape is known on the host, only the
// values live here.  One launch, with the host challenger's discipline
// (iop/challenger.py):
//   * if a kernel filled the last pending slot (K8's witness), duplex;
//   * absorb the rows * cols words of src, column by column (src[r * stride
//     + c] is word c * rows + r: rows = 4 reads a cap's digests, rows = 2
//     an extension polynomial's coefficients): each clears the outputs,
//     and a full buffer of 8 duplexes (overwrite mode);
//   * draw n_draws words to dst, popping the outputs from the end and
//     duplexing first when inputs are pending or no output is left;
//     where idx is given, also dst[d] & index_mask (the query indices);
//     where powers is given, the powers beta^0 .. beta^(arity - 1) of
//     beta = (dst[0], dst[1]) as a (2, arity) array (the fold's weights);
//   * write the state and the pending inputs back.
// A duplexing writes the pending inputs over the state's first words and
// permutes; every state word is kept canonical.
//
// Bound on an H100: latency.  The FRI part of a flagship proof runs ~37
// permutations in 6 launches (8 a layer's 16-digest cap, 1 the final
// polynomial, 4 for the grind's witness, its response and the 28 query
// indices), each depending on the one before: ~4k products each is
// nothing for the card, so the floor is one permutation's latency after
// another, ~0.02-0.03 ms each over four lanes (K2's narrow top, K7).
//
// Design: one warp, K2's split permutation (permute_lanes, four lanes a
// state, tables in shared memory).  Every group of four lanes runs the same
// permutation on the same words, so the warp's control stays uniform and
// every lane holds the words its shuffles read; lane 0 writes.  A block of
// up to 8 inputs is read by 8 lanes at once into shared memory, one
// memory latency a duplexing.
__device__ __forceinline__ void sponge_duplex(LaneState<TAIL_LANES>& st, int lane,
                                              const uint64_t* pending, int n_in,
                                              const TailTables& t) {
#pragma unroll
  for (int k = 0; k < LaneState<TAIL_LANES>::K; k++) {
    const int w = lane + TAIL_LANES * k;
    if (w < n_in) st.s[k] = pending[w];
  }
  permute_lanes(st, lane, t);
#pragma unroll
  for (int k = 0; k < LaneState<TAIL_LANES>::K; k++) st.s[k] = gl::canon(st.s[k]);
}

constexpr int SPONGE_THREADS = 32;

__global__ void __launch_bounds__(SPONGE_THREADS, 1)
sponge_kernel(uint64_t* buf, const uint64_t* __restrict__ src, int rows, int64_t stride,
              int64_t cols, int n_in, int n_out, uint64_t* dst, int n_draws, uint64_t* idx,
              uint64_t index_mask, uint64_t* powers, int arity) {
  constexpr int K = LaneState<TAIL_LANES>::K;
  __shared__ TailTables t;
  __shared__ uint64_t pending[RATE];
  load_tail_tables(t);
  if (threadIdx.x < RATE) pending[threadIdx.x] = buf[WIDTH + threadIdx.x];
  const int lane = threadIdx.x % TAIL_LANES;
  LaneState<TAIL_LANES> st;
#pragma unroll
  for (int k = 0; k < K; k++) st.s[k] = buf[lane + TAIL_LANES * k];
  __syncthreads();
  if (n_in == RATE) {
    sponge_duplex(st, lane, pending, n_in, t);
    n_in = 0;
    n_out = RATE;
  }
  const int64_t total = (int64_t)rows * cols;
  for (int64_t k = 0; k < total;) {
    const int64_t left = total - k;
    const int take = left < RATE - n_in ? (int)left : RATE - n_in;
    __syncwarp();  // the last duplexing has read the pending inputs
    if (threadIdx.x < take) {
      const int64_t e = k + threadIdx.x;
      pending[n_in + threadIdx.x] = src[(e % rows) * stride + e / rows];
    }
    __syncwarp();
    n_in += take;
    n_out = 0;
    k += take;
    if (n_in == RATE) {
      sponge_duplex(st, lane, pending, n_in, t);
      n_in = 0;
      n_out = RATE;
    }
  }
  uint64_t beta0 = 0, beta1 = 0;
  for (int d = 0; d < n_draws; d++) {
    if (n_in > 0 || n_out == 0) {
      sponge_duplex(st, lane, pending, n_in, t);
      n_in = 0;
      n_out = RATE;
    }
    n_out--;
    // word n_out sits in slot n_out / 4 of lane n_out % 4 (no dynamic
    // register index: the slot is selected)
    const int slot = n_out / TAIL_LANES;
    const uint64_t mine = slot == 0 ? st.s[0] : slot == 1 ? st.s[1] : st.s[2];
    const uint64_t v = __shfl_sync(FULL_MASK, mine, n_out % TAIL_LANES, TAIL_LANES);
    if (d == 0) beta0 = v;
    if (d == 1) beta1 = v;
    if (threadIdx.x == 0) {
      dst[d] = v;
      if (idx != nullptr) idx[d] = v & index_mask;
    }
  }
  if (powers != nullptr && threadIdx.x == 0) {
    // (p0 + p1 X)(b0 + b1 X) = p0 b0 + 7 p1 b1 + (p0 b1 + p1 b0) X
    uint64_t p0 = 1, p1 = 0;
    for (int i = 0; i < arity; i++) {
      powers[i] = p0;
      powers[arity + i] = p1;
      const uint64_t q0 = gl::add(gl::mul(p0, beta0), gl::mul(gl::mul(p1, beta1), 7));
      const uint64_t q1 = gl::add(gl::mul(p0, beta1), gl::mul(p1, beta0));
      p0 = q0;
      p1 = q1;
    }
  }
  __syncwarp();
  if (threadIdx.x < TAIL_LANES) {
#pragma unroll
    for (int k = 0; k < K; k++) buf[lane + TAIL_LANES * k] = st.s[k];
  }
  if (threadIdx.x < n_in) buf[WIDTH + threadIdx.x] = pending[threadIdx.x];
}

// ---------------------------------------------------------------------------
// K8: the FRI proof-of-work grind (port-only).  The JAX package grinds in
// XLA inside its fused FRI (plonky2_tpu/fri/device_prover.py:_fused_fri_fn
// :447-490, no Pallas kernel); the plain version here is
// hash/poseidon_cuda.py:pow_grind.  The base state is the sponge's duplex
// input: words j < n_in from inputs, the others from state (K9's buffer:
// state = buf, inputs = buf + 12, and pos = n_in, the next pending slot;
// the host-state form passes 12 words and n_in = 0).  Candidate witness w
// sets word pos; it passes if the canonical response, word 7 of the
// permuted state, is below 2^(64 - bits) (every w at 0 bits).  The kernel
// writes the smallest passing w in [start, limit), or 2^64 - 1, to out and,
// where given, to slot (K9's pending slot, which the next K9 launch
// absorbs: no host between the grind and the draws after it).
//
// Bound on an H100: integer operations, one permutation a candidate up to
// the witness (at 16 bits 2^16 expected, ~0.1 ms at K1's rate).
//
// What its time was (scripts/port_pow_grind_step0.py, stamps at the
// blocks' entries and exits beside CUDA events; H100 at 700 W, PERF.md):
// the host's share between the events (the occupancy query, the launch)
// was 0.01-0.02 ms; the rest was rounds of the resident grid (two blocks
// of 128 an SM, 33,792 candidates), each as long as one thread's
// permutation at that occupancy, ~0.076 ms (one block an SM, half the
// candidates: ~0.065 ms), and blocks that took a new chunk from the ticket
// before the pass was recorded ran part of a round more (0.083 -> 0.124
// ms at the same witness).
//
// Design: K1's permute, one thread a candidate, the largest round the
// registers allow (the resident grid, worked out once a device), and the
// rounds in lockstep: a cooperative launch, a grid barrier after each
// round, then every block reads the smallest pass (atomicMin) and all stop
// together after the first round with one.  Every candidate below it was
// tried in that round or an earlier one, so the answer is the smallest
// pass, as the host grind and the JAX package find it, and the proof stays
// byte-identical; no block starts a round after the pass.  The smallest
// pass lives in scratch, a buffer kept for the card, which block 0 resets
// after a last barrier, so a launch needs no upload before it and no
// download after it.  scratch: [0] smallest pass (2^64 - 1 between
// launches); the last launch's record: [1] block 0's entry, [2] its exit
// (%globaltimer, ns), [3] rounds, [4] the answer.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void __launch_bounds__(THREADS, 1)
pow_grind_kernel(const uint64_t* __restrict__ state, const uint64_t* __restrict__ inputs,
                 int n_in, int pos, int bits, uint64_t start, uint64_t limit,
                 unsigned long long* scratch, uint64_t* out, uint64_t* slot) {
  constexpr unsigned long long NONE = ~0ull;
  const unsigned long long t0 = global_ns();
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  __shared__ uint64_t base[WIDTH];
  if (threadIdx.x < WIDTH)
    base[threadIdx.x] = (int)threadIdx.x < n_in ? inputs[threadIdx.x] : state[threadIdx.x];
  __syncthreads();
  uint64_t b[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; j++) b[j] = base[j];
  // bits = 64: only a response of 0 passes
  const uint64_t bound = bits == 0 ? 0 : 1ull << (64 - bits);
  const uint64_t round = (uint64_t)gridDim.x * blockDim.x;
  unsigned long long found = NONE;
  unsigned long long rounds = 0;
  for (uint64_t s = start;;) {
    const uint64_t w = s + (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (w < limit) {
      uint64_t st[WIDTH];
#pragma unroll
      for (int j = 0; j < WIDTH; j++) st[j] = j == pos ? w : b[j];
      permute(st);
      if (bits == 0 || gl::canon(st[RATE - 1]) < bound) atomicMin(scratch, (unsigned long long)w);
    }
    grid.sync();
    rounds++;
    found = __ldcg(scratch);
    s += round;
    if (found != NONE || s >= limit) break;
  }
  grid.sync();  // every block has read the answer before block 0 resets it
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    out[0] = found;
    if (slot != nullptr) slot[0] = found;
    scratch[0] = NONE;
    scratch[1] = t0;
    scratch[2] = global_ns();
    scratch[3] = rounds;
    scratch[4] = found;
  }
}

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

extern "C" int plk_compress_tail(const void* in, void* out, long long m0, int n_levels, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (m0 == 0 || n_levels == 0) return 0;
  auto kernel = compress_tail_kernel<TAIL_LANES>;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TAIL_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long needed = (m0 * TAIL_LANES + TAIL_THREADS - 1) / TAIL_THREADS;
  const long long resident = (long long)per_sm * sms;
  if (resident == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned blocks = (unsigned)(needed < resident ? needed : resident);
  const uint64_t* a = (const uint64_t*)in;
  uint64_t* b = (uint64_t*)out;
  int64_t m = (int64_t)m0;
  void* args[] = {(void*)&a, (void*)&b, (void*)&m, (void*)&n_levels};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(TAIL_THREADS), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int plk_poseidon_wires_waves(void* values, const void* dep_idx, const void* out_idx,
                                        const void* offsets, int n_waves, long long R,
                                        long long max_rows, void* err, int device,
                                        void* stream) {
  cudaError_t err_ = cudaSetDevice(device);
  if (err_ != cudaSuccess) return (int)err_;
  if (n_waves == 0 || max_rows == 0) return 0;
  auto kernel = poseidon_waves_kernel<TAIL_LANES>;
  int per_sm = 0, sms = 0;
  err_ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, TAIL_THREADS, 0);
  if (err_ != cudaSuccess) return (int)err_;
  err_ = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err_ != cudaSuccess) return (int)err_;
  const long long needed = (max_rows * TAIL_LANES + TAIL_THREADS - 1) / TAIL_THREADS;
  const long long resident = (long long)per_sm * sms;
  if (resident == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const unsigned blocks = (unsigned)(needed < resident ? needed : resident);
  uint64_t* v = (uint64_t*)values;
  const int32_t* d = (const int32_t*)dep_idx;
  const int32_t* o = (const int32_t*)out_idx;
  const int64_t* offs = (const int64_t*)offsets;
  int64_t r = (int64_t)R;
  int* e = (int*)err;
  void* args[] = {(void*)&v, (void*)&d, (void*)&o, (void*)&offs, (void*)&n_waves, (void*)&r, (void*)&e};
  err_ = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(TAIL_THREADS), args, 0,
                                     (cudaStream_t)stream);
  if (err_ != cudaSuccess) return (int)err_;
  return (int)cudaGetLastError();
}

// K8's grid: as many blocks as fit the card at once (a cooperative launch),
// worked out once a device.
extern "C" int plk_pow_grind(const void* state, const void* inputs, int n_in, int pos, int bits,
                             long long start, long long limit, void* scratch, void* out, void* slot,
                             int device, void* stream) {
  static int resident[64];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (device < 0 || device >= 64 || n_in < 0 || n_in > RATE || pos < 0 || pos >= WIDTH ||
      bits < 0 || bits > 64 || start < 0 || limit < start)
    return (int)cudaErrorInvalidValue;
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pow_grind_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    resident[device] = per_sm * sms;
    if (resident[device] == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  const uint64_t* st = (const uint64_t*)state;
  const uint64_t* in = (const uint64_t*)inputs;
  uint64_t s0 = (uint64_t)start, lim = (uint64_t)limit;
  unsigned long long* scr = (unsigned long long*)scratch;
  uint64_t* o = (uint64_t*)out;
  uint64_t* sl = (uint64_t*)slot;
  void* args[] = {(void*)&st, (void*)&in, (void*)&n_in, (void*)&pos, (void*)&bits,
                  (void*)&s0, (void*)&lim, (void*)&scr, (void*)&o, (void*)&sl};
  err = cudaLaunchCooperativeKernel((const void*)pow_grind_kernel, dim3(resident[device]),
                                    dim3(THREADS), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int plk_sponge(void* buf, const void* src, int rows, long long stride, long long cols,
                          int n_in, int n_out, void* dst, int n_draws, void* idx,
                          long long index_mask, void* powers, int arity, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || rows > 4 || cols < 0 || n_in < 0 || n_in > RATE || n_out < 0 || n_out > RATE ||
      n_draws < 0 || arity < 0 || (powers != nullptr && n_draws < 2))
    return (int)cudaErrorInvalidValue;
  sponge_kernel<<<1, SPONGE_THREADS, 0, (cudaStream_t)stream>>>(
      (uint64_t*)buf, (const uint64_t*)src, rows, (int64_t)stride, (int64_t)cols, n_in, n_out,
      (uint64_t*)dst, n_draws, (uint64_t*)idx, (uint64_t)index_mask, (uint64_t*)powers, arity);
  return (int)cudaGetLastError();
}

extern "C" const char* plk_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
