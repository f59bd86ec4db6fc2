// Kernels K3, K4 and K5: radix-2 NTTs of a (B, n1, n2) batch, down its
// columns (axis -2) or along its rows (axis -1, the contiguous one).
//
// K3 replaces plonky2_tpu/ops/ntt_pallas.py:ntt_cols_pallas (natural order
// in and out; the inverse swaps in inverse twiddles and does not scale by
// 1/n).  K4 replaces ntt_pallas.py:ntt_cols_zero_tail_pallas: K3 on a
// (B, n1 / 2^r, n2) prefix whose tail rows are implied zeros.  K5 replaces
// ntt_pallas.py:ntt_cols_dif_pallas (natural order in, bit-reversed order
// out, optional implied zero tail of n1 - q rows).  They compute what the
// TPU kernels compute; the roll/select butterflies and lane tiles were how
// the TPU did it.  Two forms go beyond the TPU kernels, so that the
// four-step schedule (parallel/four_step.py) copies no matrix to transpose
// it: K3's row form (plk_ntt_rows_dit), which stores its result
// transposed, and K5's row form (plk_ntt_rows_dif), which runs in place.
//
// Optional fused pointwise products (nullptr to skip), which the JAX
// package left to XLA between kernels: `pre` multiplies the input as it is
// loaded and `post` the output as it is stored, each a table of the input's
// or the output's (rows, n2) shape shared by the batch (the row forms: K3's
// takes `post` only).  The four-step schedule puts the coset shift, the
// step-2 twiddles and the 1/n scale there, so they never make an extra pass
// over the matrix.
//
// One network for all forms: every transform is a radix-2 DIF network
// (natural order in, bit-reversed order out); the natural-order forms (K3,
// K4) store slot p at position rev(p).  The NTT is exact, so any network
// gives the same field elements.  K4's and K5's zero tail: with Q = 2^k >= q
// rows of input and r = log2(n1 / Q), the first r DIF stages only scale
// copies of the prefix, and segment c of Q slots starts as
// prefix[i] * w_n1^(i * rev_r(c)) (the `factors` table, n1 words).  Each
// segment is then a Q-point DIF of its own.
//
// Bound on an H100.  The floor is HBM bytes (each element read once and
// written once; ~4 log2(n) int32 multiplies per 16 bytes moved is below the
// card's int32-ops-per-byte line).  What binds these kernels is the integer
// ALU pipe: a canonical Goldilocks butterfly is ~38 ALU instructions
// (carries, compares, selects, the reduction) beside 4 IMAD.WIDE, and the
// ALU pipe issues 64 a clock an SM, so the commit's 11 stages of rows of
// 2^11 take ~4 ms of issue where their bytes take 2.3 ms (PERF.md: with the
// butterflies' arithmetic stripped the row form runs at 83% of HBM peak;
// without its device-memory traffic it is nearly as slow as with it).
// Design:
//  - Rounds of up to four stages in registers.  A thread holds the 16 slots
//    of one line that four consecutive stages combine, runs the four stages
//    there and exchanges through shared memory between rounds: a 2^11-point
//    line takes three rounds (3 + 4 + 4 stages) and three barriers instead
//    of eleven.  The 2^k - 1 twiddles a round needs are read once each from
//    shared memory; stage 0's twiddles, and in the last round each stage's
//    first, are 1 and skip the product.  Lines sit in shared memory with
//    one spare word after every 16 and every 256 slots, so that the rounds'
//    strided accesses and the bit-reversed reads of the row store hit
//    distinct banks, and a round's 16 slots lie at a fixed stride.
//  - Fewest ALU instructions a butterfly: add and subtract in 32-bit carry
//    chains with one select, the product in goldilocks.cuh's throughput
//    form and its reduction fused with the canonical subtraction.
//  - A register cap of 128 that spills nothing: two 256-thread column
//    blocks or four 128-thread row blocks an SM.  Uncapped, the forms take
//    126-168 registers and the column forms run 30-50% slower; a cap of 80
//    (three 256-thread blocks) is 7-16% faster on the column forms but
//    spills 4-16 bytes a thread (PERF.md).
//  - Column forms: a block takes T columns of one batch entry (T * Q near
//    8192 words, 4096 with a zero tail: 64 B to 256 B runs per row), thread
//    index column first.  The first round reads its slots straight from
//    device memory (or, with a zero tail, from the prefix tile staged once
//    in shared memory), and the last round writes straight to device
//    memory: a warp's load or store is one run of T words per row, whatever
//    the row order.  With a zero tail the block walks the 2^r segments, so
//    no zero is loaded and no butterfly runs on zeros.
//  - Row forms: a persistent block takes R rows at a time (R * n2 near 4096
//    words; R >= 4 for the transposed store, 32 B runs) and keeps its
//    twiddles in shared memory.  The first round reads straight from device
//    memory (a warp reads 32 consecutive words); the result goes through
//    shared memory, so the store writes consecutive words of a row (K5's,
//    in place: a block reads all its rows before it writes any) or runs of
//    R words of a column (K3's, transposed, in natural order).
#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

constexpr int COL_THREADS = 256;
constexpr int ROW_THREADS = 128;
constexpr int KMAX = 4;               // stages a round keeps in registers
constexpr int ROW_TILE_WORDS = 4096;  // R * n2, the row forms' tile
constexpr int LOG_R_TRANSPOSED = 2;   // R >= 4: a transposed store writes 32 B runs
// Blocks an SM that __launch_bounds__ asks for: with the thread counts
// above, both cap a thread at 128 registers, where no form spills (uncapped
// they take 126-168)
constexpr int COL_MIN_BLOCKS = 2;
constexpr int ROW_MIN_BLOCKS = 4;

// Offset of slot p in a line of shared memory: a spare word after every 16
// and every 256 slots.  For p = a + b with a and b on disjoint bits,
// pad(p) = pad(a) + pad(b); and pad(j << s) = j * pad(1 << s) for j < 16
// and s a multiple of 4, so a round's 16 slots lie at a fixed stride.
__host__ __device__ __forceinline__ int pad(int p) { return p + (p >> 4) + (p >> 8); }

// Words between two lines: odd, so that the column forms' warps (column
// index first) hit distinct banks.
__host__ __device__ __forceinline__ int line_words(int len) { return pad(len) | 1; }

__device__ __forceinline__ int rev_bits(int x, int bits) {
  return bits ? (int)(__brev((unsigned)x) >> (32 - bits)) : 0;
}

__host__ __device__ constexpr int rev_const(int x, int bits) {
  return bits == 0 ? 0 : ((x & 1) << (bits - 1)) | rev_const(x >> 1, bits - 1);
}

// a + b and a - b for canonical a, b, canonical, in 32-bit carry chains:
// a + b - p is taken when the 65-bit sum minus p does not borrow (c is then
// 0, else all ones, and lop3 0xe4 is c ? sum : sum - p); a - b gets p added
// back when it borrows.
__device__ __forceinline__ uint64_t add_canon(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t.reg .u32 a0, a1, b0, b1, s0, s1, t0, t1, c;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 s0, a0, b0;\n\t"
      "addc.cc.u32 s1, a1, b1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.cc.u32 t0, s0, 1;\n\t"
      "subc.cc.u32 t1, s1, 0xffffffff;\n\t"
      "subc.u32 c, c, 0;\n\t"
      "lop3.b32 s0, s0, t0, c, 0xe4;\n\t"
      "lop3.b32 s1, s1, t1, c, 0xe4;\n\t"
      "mov.b64 %0, {s0, s1};\n\t}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

__device__ __forceinline__ uint64_t sub_canon(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t.reg .u32 a0, a1, b0, b1, d0, d1, m, m0;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "sub.cc.u32 d0, a0, b0;\n\t"
      "subc.cc.u32 d1, a1, b1;\n\t"
      "subc.u32 m, 0, 0;\n\t"
      "and.b32 m0, m, 1;\n\t"
      "add.cc.u32 d0, d0, m0;\n\t"
      "addc.u32 d1, d1, m;\n\t"
      "mov.b64 %0, {d0, d1};\n\t}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

// a * b, canonical: the product in goldilocks.cuh's throughput form, then
// lo + hi * 2^64 = lo - hi_hi + hi_lo * EPSILON (mod p), a value below
// 2p - 1 (lo - hi_hi is below 2^64 after one borrow fix, hi_lo * EPSILON
// below 2^64 - 2^33 + 2), brought below p by one conditional subtraction:
// reduce128_cc and canon in one carry chain.
__device__ __forceinline__ uint64_t mul_canon(uint64_t a, uint64_t b) {
  uint64_t lo, hi, r;
  gl::mul_wide_split(a, b, lo, hi);
  asm("{\n\t.reg .u32 l0, l1, h0, h1, t0, t1, br, u0, u1, s0, s1, r0, r1, c;\n\t"
      "mov.b64 {l0, l1}, %1;\n\t"
      "mov.b64 {h0, h1}, %2;\n\t"
      "sub.cc.u32 t0, l0, h1;\n\t"
      "subc.cc.u32 t1, l1, 0;\n\t"
      "subc.u32 br, 0, 0;\n\t"
      "sub.cc.u32 t0, t0, br;\n\t"
      "subc.u32 t1, t1, 0;\n\t"
      "sub.cc.u32 u0, 0, h0;\n\t"
      "subc.u32 u1, h0, 0;\n\t"
      "add.cc.u32 s0, t0, u0;\n\t"
      "addc.cc.u32 s1, t1, u1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "sub.cc.u32 r0, s0, 1;\n\t"
      "subc.cc.u32 r1, s1, 0xffffffff;\n\t"
      "subc.u32 c, c, 0;\n\t"
      "lop3.b32 r0, s0, r0, c, 0xe4;\n\t"
      "lop3.b32 r1, s1, r1, c, 0xe4;\n\t"
      "mov.b64 %0, {r0, r1};\n\t}"
      : "=l"(r)
      : "l"(lo), "l"(hi));
  return r;
}

// The DIF butterfly (u, v) -> (u + v, (u - v) w), and its form for w = 1.
__device__ __forceinline__ void dif_butterfly(uint64_t& x, uint64_t& y, uint64_t w) {
  const uint64_t d = sub_canon(x, y);
  x = add_canon(x, y);
  y = mul_canon(d, w);
}

__device__ __forceinline__ void dif_butterfly1(uint64_t& x, uint64_t& y) {
  const uint64_t d = sub_canon(x, y);
  x = add_canon(x, y);
  y = d;
}

// Stages s_lo + K - 1 down to s_lo of a DIF network on the 2^K slots
// x_j = base + j * 2^s_lo of one line (base = hi * 2^(s_lo + K) + lo).  The
// twiddle of stage s at slot x is w_{2^(s+1)}^(x mod 2^s) = tw[2^s - 1 + x mod
// 2^s], and x mod 2^s = (j mod 2^b) * 2^s_lo + lo for s = s_lo + b.  Stage 0's
// twiddles are all 1.
template <int K>
__device__ __forceinline__ void dif_stages(uint64_t (&v)[1 << K], const uint64_t* tw, int s_lo,
                                           int lo) {
#pragma unroll
  for (int b = K - 1; b >= 0; b--) {
    const int h = 1 << b;
    if (b == 0 && s_lo == 0) {
#pragma unroll
      for (int g = 0; g < (1 << K); g += 2) dif_butterfly1(v[g], v[g + 1]);
      continue;
    }
    const uint64_t* t = tw + (1 << (s_lo + b)) - 1 + lo;
#pragma unroll
    for (int m = 0; m < h; m++) {
      const uint64_t w = t[m << s_lo];
      if (m == 0 && s_lo == 0) {  // lo = 0, so w = 1
#pragma unroll
        for (int g = 0; g < (1 << K); g += 2 * h) dif_butterfly1(v[g], v[g + h]);
        continue;
      }
#pragma unroll
      for (int g = 0; g < (1 << K); g += 2 * h) dif_butterfly(v[g + m], v[g + m + h], w);
    }
  }
}

// One round on one line: load the 2^K slots (from device memory in the
// first round, else from the line in shared memory), run the K stages and
// store them (to device memory in the last round of a column form, else
// back to the same slots).  s_lo is a multiple of 4 (dif_rounds), and 0 in
// a last round.
template <int K, bool FIRST, bool LAST, class Ctx>
__device__ __forceinline__ void round_line(const Ctx& cx, int line, int s_lo, int lo, int base) {
  uint64_t v[1 << K];
  uint64_t* ln = cx.work + line * cx.S + pad(base);
  const int stride = pad(1 << s_lo);
  if constexpr (FIRST) {
    cx.template load<K>(v, line, base, s_lo);
  } else {
#pragma unroll
    for (int j = 0; j < (1 << K); j++) v[j] = ln[j * stride];
  }
  dif_stages<K>(v, cx.tw, s_lo, lo);
  if constexpr (LAST) {
    cx.template store<K>(v, line, base);
  } else {
#pragma unroll
    for (int j = 0; j < (1 << K); j++) ln[j * stride] = v[j];
  }
}

template <bool LAST, class Ctx>
__device__ __forceinline__ void first_round(const Ctx& cx, int k, int line, int s_lo, int lo,
                                            int base) {
  switch (k) {
    case 0: round_line<0, true, LAST>(cx, line, s_lo, lo, base); break;
    case 1: round_line<1, true, LAST>(cx, line, s_lo, lo, base); break;
    case 2: round_line<2, true, LAST>(cx, line, s_lo, lo, base); break;
    case 3: round_line<3, true, LAST>(cx, line, s_lo, lo, base); break;
    default: round_line<4, true, LAST>(cx, line, s_lo, lo, base); break;
  }
}

// All rounds of a DIF network of 2^L slots on each of the block's lines.
// The first round takes L mod 4 stages (4 if that is 0; none if L = 0), the
// others four, so every round's lowest stage is a multiple of 4.
// cx.item(w, s_lo, s_top, L, line, lo, hi) maps work item w of a round to
// its line and slots; the column forms put the line first, the row forms
// the slot.
template <int THREADS, bool COLS_LAST_TO_DEVICE, class Ctx>
__device__ __forceinline__ void dif_rounds(const Ctx& cx, int L, int n_lines_log) {
  const int nrounds = L == 0 ? 1 : (L + KMAX - 1) / KMAX;
  int s_top = L;
  for (int rd = 0; rd < nrounds; rd++) {
    const int k = rd == 0 ? L - KMAX * (nrounds - 1) : KMAX;
    const int s_lo = s_top - k;
    const bool last = rd == nrounds - 1;
    const int items = 1 << (n_lines_log + L - k);
    for (int w = threadIdx.x; w < items; w += THREADS) {
      int line, lo, hi;
      cx.item(w, s_lo, s_top, L, line, lo, hi);
      const int base = (hi << s_top) + lo;
      if constexpr (COLS_LAST_TO_DEVICE) {
        if (rd == 0) {
          if (last)
            first_round<true>(cx, k, line, s_lo, lo, base);
          else
            first_round<false>(cx, k, line, s_lo, lo, base);
        } else if (last) {
          round_line<KMAX, false, true>(cx, line, s_lo, lo, base);
        } else {
          round_line<KMAX, false, false>(cx, line, s_lo, lo, base);
        }
      } else if (rd == 0) {
        first_round<false>(cx, k, line, s_lo, lo, base);
      } else {
        round_line<KMAX, false, false>(cx, line, s_lo, lo, base);
      }
    }
    s_top = s_lo;
    __syncthreads();
  }
}

// ---------------------------------------------------------------- columns

// v[rev_K(i)] (times post) to output row i of 2^K rows at stride rs, for
// i = I .. 2^K - 1: the recursion makes each bit-reversed slot a
// compile-time index, so v stays in registers.
template <int K, int I = 0>
__device__ __forceinline__ void store_rows_natural(const uint64_t (&v)[1 << K], uint64_t* y,
                                                   const uint64_t* f, bool post, int64_t rs) {
  if constexpr (I < (1 << K)) {
    constexpr int j = rev_const(I, K);
    y[I * rs] = post ? mul_canon(v[j], f[I * rs]) : v[j];
    store_rows_natural<K, I + 1>(v, y, f, post, rs);
  }
}

template <bool NATURAL>
struct ColCtx {
  const uint64_t* src;     // (q, n2) rows of this batch entry, from column j0
  const uint64_t* pre;     // (q, n2) or nullptr
  const uint64_t* post;    // (n1, n2) or nullptr
  const uint64_t* factor;  // (n1,) zero-tail factors, segment seg at seg * Q
  const uint64_t* prefix;  // (Q, T) prefix tile in shared memory (r > 0)
  const uint64_t* tw;      // (Q,) twiddles in shared memory
  uint64_t* work;          // T lines of S words
  uint64_t* dst;           // (n1, n2) output of this batch entry, column j0
  int64_t n2, j0;
  int S, log_t, q, r, seg, log_q, log_n1;

  __device__ __forceinline__ void item(int w, int s_lo, int s_top, int L, int& line, int& lo,
                                       int& hi) const {
    line = w & ((1 << log_t) - 1);
    const int rest = w >> log_t;
    lo = rest & ((1 << s_lo) - 1);
    hi = rest >> s_lo;
  }
  // The first round's 2^K slots base + j * 2^s_lo of column c.
  template <int K>
  __device__ __forceinline__ void load(uint64_t (&v)[1 << K], int c, int base, int s_lo) const {
    if (r > 0) {  // the prefix tile, times the segment's factors
      const uint64_t* x = prefix + (base << log_t) + c;
      const int xs = 1 << (s_lo + log_t);
#pragma unroll
      for (int j = 0; j < (1 << K); j++) v[j] = x[j * xs];
      if (seg) {
        const uint64_t* f = factor + (seg << log_q) + base;
#pragma unroll
        for (int j = 0; j < (1 << K); j++) v[j] = mul_canon(v[j], f[j << s_lo]);
      }
      return;
    }
    const int64_t xs = n2 << s_lo;
    const uint64_t* x = src + base * n2 + c;
    if (q == (1 << log_q)) {
#pragma unroll
      for (int j = 0; j < (1 << K); j++) v[j] = x[j * xs];
    } else {  // K5 with q not a power of two: rows from q on are zeros
#pragma unroll
      for (int j = 0; j < (1 << K); j++) v[j] = base + (j << s_lo) < q ? x[j * xs] : 0;
    }
    if (pre) {
      const uint64_t* f = pre + base * n2 + j0 + c;
#pragma unroll
      for (int j = 0; j < (1 << K); j++) v[j] = mul_canon(v[j], f[j * xs]);
    }
  }
  // The last round's 2^K consecutive slots from base (s_lo = 0, base a
  // multiple of 2^K): to rows slot (bit-reversed order) or rev(slot)
  // (natural order), which are rev(slot0) + rev_K(j) * 2^(log_n1 - K).  In
  // both orders output row i of the 2^K takes slot j = i or rev_K(i), so the
  // rows go out at a fixed stride.
  template <int K>
  __device__ __forceinline__ void store(const uint64_t (&v)[1 << K], int c, int base) const {
    const int slot0 = (seg << log_q) + base;
    const int64_t row0 = NATURAL ? rev_bits(slot0, log_n1) : slot0;
    const int64_t rs = NATURAL ? n2 << (log_n1 - K) : n2;
    uint64_t* y = dst + row0 * n2 + c;
    const uint64_t* f = post + row0 * n2 + j0 + c;
    if constexpr (NATURAL) {
      store_rows_natural<K>(v, y, f, post, rs);
    } else {
#pragma unroll
      for (int i = 0; i < (1 << K); i++) y[i * rs] = post ? mul_canon(v[i], f[i * rs]) : v[i];
    }
  }
};

// One block per (tile of T columns, batch entry).  in (B, q, n2) -> out
// (B, n1, n2); Q = 2^log_q >= q, r = log_n1 - log_q.
template <bool NATURAL>
__global__ void __launch_bounds__(COL_THREADS, COL_MIN_BLOCKS)
    ntt_cols_kernel(const uint64_t* __restrict__ in, uint64_t* __restrict__ out,
                    const uint64_t* __restrict__ twiddles, const uint64_t* __restrict__ factors,
                    const uint64_t* __restrict__ pre, const uint64_t* __restrict__ post, int q,
                    int log_q, int log_n1, int64_t n2, int log_t) {
  extern __shared__ uint64_t smem[];
  const int Q = 1 << log_q, T = 1 << log_t, r = log_n1 - log_q;
  ColCtx<NATURAL> cx;
  cx.S = line_words(Q);
  cx.work = smem;
  uint64_t* tw = smem + T * cx.S;
  uint64_t* prefix = tw + Q;
  cx.tw = tw;
  cx.prefix = prefix;
  cx.j0 = (int64_t)blockIdx.x * T;
  cx.src = in + (int64_t)blockIdx.y * q * n2 + cx.j0;
  cx.dst = out + ((int64_t)blockIdx.y << log_n1) * n2 + cx.j0;
  cx.pre = pre;
  cx.post = post;
  cx.factor = factors;
  cx.n2 = n2;
  cx.log_t = log_t;
  cx.q = q;
  cx.r = r;
  cx.log_q = log_q;
  cx.log_n1 = log_n1;

  for (int k = threadIdx.x; k < Q; k += COL_THREADS) tw[k] = twiddles[k];
  if (r > 0) {
    for (int k = threadIdx.x; k < (Q << log_t); k += COL_THREADS) {
      const int i = k >> log_t, c = k & (T - 1);
      uint64_t v = 0;
      if (i < q) {
        v = cx.src[i * n2 + c];
        if (pre) v = mul_canon(v, pre[i * n2 + cx.j0 + c]);
      }
      prefix[k] = v;
    }
  }
  __syncthreads();
  for (int seg = 0; seg < (1 << r); seg++) {
    cx.seg = seg;
    dif_rounds<COL_THREADS, true>(cx, log_q, log_t);
  }
}

// ------------------------------------------------------------------- rows

struct RowCtx {
  const uint64_t* src;  // (R, n2) rows of this group
  const uint64_t* tw;   // (n2,) twiddles in shared memory
  uint64_t* work;       // R lines of S words
  int S, log_n2;

  __device__ __forceinline__ void item(int w, int s_lo, int s_top, int L, int& line, int& lo,
                                       int& hi) const {
    lo = w & ((1 << s_lo) - 1);
    const int rest = w >> s_lo;
    hi = rest & ((1 << (L - s_top)) - 1);
    line = rest >> (L - s_top);
  }
  template <int K>
  __device__ __forceinline__ void load(uint64_t (&v)[1 << K], int line, int base, int s_lo) const {
    const uint64_t* x = src + ((int64_t)line << log_n2) + base;
#pragma unroll
    for (int j = 0; j < (1 << K); j++) v[j] = x[j << s_lo];
  }
};

// A persistent grid walks the B * n1 rows in groups of R = 2^log_r (R
// divides n1).  DIT (K3's row form): natural order, stored transposed into
// out (B, n2, n1), times post (n2, n1) where given.  DIF (K5's row form):
// bit-reversed order, in place (in == out, (B, n1, n2)); a block reads all
// its rows before it writes any.
template <bool DIT>
__global__ void __launch_bounds__(ROW_THREADS, ROW_MIN_BLOCKS)
    ntt_rows_kernel(const uint64_t* in, uint64_t* out, const uint64_t* __restrict__ twiddles,
                    const uint64_t* __restrict__ post, int64_t n_groups, int log_n1, int log_n2,
                    int log_r) {
  extern __shared__ uint64_t smem[];
  const int N = 1 << log_n2, R = 1 << log_r;
  RowCtx cx;
  cx.S = line_words(N);
  cx.work = smem;
  uint64_t* tw = smem + R * cx.S;
  cx.tw = tw;
  cx.log_n2 = log_n2;
  for (int k = threadIdx.x; k < N; k += ROW_THREADS) tw[k] = twiddles[k];
  __syncthreads();

  for (int64_t g = blockIdx.x; g < n_groups; g += gridDim.x) {
    const int64_t row0 = g << log_r;
    cx.src = in + (row0 << log_n2);
    dif_rounds<ROW_THREADS, false>(cx, log_n2, log_r);
    if (DIT) {
      // out[b, k, k1]: consecutive threads store the group's R rows of one
      // output row k, then the next k
      const int64_t b = row0 >> log_n1;
      const int k1_0 = (int)(row0 & ((1 << log_n1) - 1));
      uint64_t* dst = out + ((b << log_n2) << log_n1) + k1_0;
      for (int e = threadIdx.x; e < (R << log_n2); e += ROW_THREADS) {
        const int line = e & (R - 1), k = e >> log_r;
        uint64_t v = cx.work[line * cx.S + pad(rev_bits(k, log_n2))];
        const int64_t o = ((int64_t)k << log_n1) + line;
        if (post) v = mul_canon(v, post[o + k1_0]);
        dst[o] = v;
      }
    } else {
      // consecutive threads store consecutive words of a row
      uint64_t* dst = out + (row0 << log_n2);
      for (int e = threadIdx.x; e < (R << log_n2); e += ROW_THREADS)
        dst[e] = cx.work[(e >> log_n2) * cx.S + pad(e & (N - 1))];
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------------- launch

int log2_floor(long long x) {
  int l = 0;
  while ((2LL << l) <= x) l++;
  return l;
}

template <bool NATURAL>
int launch_cols(const void* in, void* out, const void* twiddles, const void* factors,
                const void* pre, const void* post, long long B, long long q, int log_n1,
                long long n2, int log_t, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q < 0 || q > (1LL << log_n1) || log_n1 < 0 || log_n1 > 13 || log_t < 0 ||
      (n2 & ((1LL << log_t) - 1)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || n2 == 0) return 0;
  int log_q = 0;
  while ((1LL << log_q) < q) log_q++;
  if (log_q < log_n1 && factors == nullptr) return (int)cudaErrorInvalidValue;
  const size_t Q = (size_t)1 << log_q, T = (size_t)1 << log_t;
  const size_t words = T * line_words((int)Q) + Q + (log_q < log_n1 ? Q * T : 0);
  const size_t smem = words * sizeof(uint64_t);
  err = cudaFuncSetAttribute(ntt_cols_kernel<NATURAL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(n2 >> log_t), (unsigned)B);
  ntt_cols_kernel<NATURAL><<<grid, COL_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)twiddles, (const uint64_t*)factors,
      (const uint64_t*)pre, (const uint64_t*)post, (int)q, log_q, log_n1, (int64_t)n2, log_t);
  return (int)cudaGetLastError();
}

template <bool DIT>
int launch_rows(const void* in, void* out, const void* twiddles, const void* post, long long B,
                int log_n1, int log_n2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (log_n1 < 0 || log_n1 > 30 || log_n2 < 0 || log_n2 > 13 || B < 0 || (DIT && in == out))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  int log_r = log2_floor(ROW_TILE_WORDS >> log_n2);
  if (DIT && log_r < LOG_R_TRANSPOSED) log_r = LOG_R_TRANSPOSED;
  if (log_r > log_n1) log_r = log_n1;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const size_t N = (size_t)1 << log_n2;
  auto smem_of = [&](int lr) { return (((size_t)1 << lr) * line_words((int)N) + N) * 8; };
  while (log_r > 0 && smem_of(log_r) > (size_t)smem_max) log_r--;  // long transposed rows
  const size_t smem = smem_of(log_r);
  auto kernel = ntt_rows_kernel<DIT>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ROW_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long n_groups = (B << log_n1) >> log_r;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > n_groups) blocks = n_groups;
  kernel<<<(unsigned)blocks, ROW_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)in, (uint64_t*)out, (const uint64_t*)twiddles, (const uint64_t*)post,
      (int64_t)n_groups, log_n1, log_n2, log_r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plk_ntt_cols_dit(const void* in, void* out, const void* twiddles, const void* pre,
                                const void* post, long long B, int log_n1, long long n2,
                                int log_t, int device, void* stream) {
  return launch_cols<true>(in, out, twiddles, nullptr, pre, post, B, 1LL << log_n1, log_n1, n2,
                           log_t, device, stream);
}

extern "C" int plk_ntt_cols_zero_tail(const void* in, void* out, const void* twiddles,
                                      const void* factors, const void* pre, const void* post,
                                      long long B, int rate_bits, int log_n1, long long n2,
                                      int log_t, int device, void* stream) {
  if (rate_bits < 0 || rate_bits > log_n1) return (int)cudaErrorInvalidValue;
  return launch_cols<true>(in, out, twiddles, factors, pre, post, B,
                           1LL << (log_n1 - rate_bits), log_n1, n2, log_t, device, stream);
}

extern "C" int plk_ntt_cols_dif(const void* in, void* out, const void* twiddles,
                                const void* factors, const void* pre, const void* post,
                                long long B, long long q, int log_n1, long long n2, int log_t,
                                int device, void* stream) {
  return launch_cols<false>(in, out, twiddles, factors, pre, post, B, q, log_n1, n2, log_t,
                            device, stream);
}

extern "C" int plk_ntt_rows_dit(const void* in, void* out, const void* twiddles,
                                const void* post, long long B, int log_n1, int log_n2,
                                int device, void* stream) {
  return launch_rows<true>(in, out, twiddles, post, B, log_n1, log_n2, device, stream);
}

extern "C" int plk_ntt_rows_dif(void* data, const void* twiddles, long long B, int log_n1,
                                int log_n2, int device, void* stream) {
  return launch_rows<false>(data, data, twiddles, nullptr, B, log_n1, log_n2, device, stream);
}
