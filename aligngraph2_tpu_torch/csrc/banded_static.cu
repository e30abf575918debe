// Static-band Smith-Waterman DP and its traceback, for Hopper (sm_90a).
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C functions at the end of this file.  Each
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError(); the wrappers in ops/banded_static.py allocate the
// outputs and raise on a nonzero code.  ops/banded_static.py also holds the
// plain torch version of each kernel, which defines the semantics below.
//
// dp_static_kernel replaces _dp_kernel of aligngraph2_tpu/ops/banded_pallas.py
// (called through banded_align_pallas).  Per lane: local alignment with
// linear gaps; cell (i, j) compares q[i-1] with t[i-1+j] (the standard
// frame, seed diagonal at column W/2); diag = H_{i-1}[j], up =
// H_{i-1}[j+1] (NEG past the last column), left = the max-plus chain along
// the row.  Directions: STOP if max(diag, up) <= 0, else DIAG if
// diag >= up, else UP; LEFT when the chain raises the cell strictly.  Best
// cell: the largest score, then the earliest row, then the smallest
// column; all zero when the score is 0.  Output words (B, NQ/16, W) int32:
// bits 2s, 2s+1 of word w hold row 16w+s+1.
//
// Design: one warp per lane, kDpLanes lanes per block; thread l owns the
// C = W/32 contiguous columns [lC, lC + C) and keeps their H, the 16-row
// direction words and its own best cell in registers.  The up neighbour
// of its last column is one __shfl_down of the next thread's first H.
// The row's gap chain is a serial max-plus prefix over the thread's C
// columns, a 5-step shuffle scan of the thread totals with weight
// gap*C*d, and a fix-up v[c] = max(v[c], carry + gap*(c+1)): no barrier
// and no shared memory per row.  Max-plus over exact integers is
// associative, so this order gives the Pallas kernel's Kogge-Stone result
// exactly.  Rows go four at a time: the thread's target window for the
// four rows (C+3 bytes) and the four query bytes are loaded one step
// ahead, and __vcmpeq4 compares four columns per instruction.  Each 16
// rows the C words leave as 16-byte stores, contiguous across the warp.
// W is a power of two from 256 to 4096, the widths the aligner forms
// (max(band_width, 256)).  W = 256, 512 and 1024 (C = 8, 16, 32) take the
// form above.  At W = 2048 and 4096, 64 or 128 columns a thread would
// spill H and the words, so a lane takes G = W / 1024 warps, one block
// (dp_static_group): warp g runs the W = 1024 form on columns [1024 g,
// 1024 g + 1024), and each row crosses the warps through shared memory
// with one barrier: each warp publishes its gap chain's total (from its
// own columns) and its first H; after the barrier the carry into warp g
// is C_g = max(T_{g-1}, C_{g-1} + 1024 gap), the final H of column
// 1024 g - 1, which the warp's fix-up takes in, and the up neighbour of
// its last column is max(H_{g+1}[0], C_{g+1} + gap).  The best cell
// reduces across the warps at the end, the x_drop test every K rows.
//
// x_drop is checked per lane every K rows (the Pallas kernel checks per
// 128-lane tile): the lane stays alive iff row i+1 <= qlen and (best == 0
// or max_j H >= best - x_drop).  A dead lane's warp exits, freeing its
// slot on the SM; its later words stay unwritten.  rows[b] is the number
// of rows the lane computed.
//
// Bound on an H100: operations.  About 20 int32 operations per cell (the
// serial form of the recurrence) against 2 bits of output per cell, so the
// integer ALUs are the limit, not the 3.35 TB/s of HBM.  The per-row
// shuffles (one up neighbour, six for the scan and its carry) are shared
// by the C cells of a thread.
//
// tb_static_kernel replaces traceback_t and traceback_packed_device of
// aligngraph2_tpu/ops/banded_pallas.py.  It walks from (best_i, best_j):
// DIAG keeps j, UP goes to (i-1, j+1), LEFT to (i, j-1); it stops at STOP,
// at i == 0 or after max_steps moves, and writes the dense moves
// END->START (zero padded by the caller), the move count and the cursor
// where it stopped.  Bound: the latency of the walk's dependent chain; a
// few bytes per step leave HBM idle.  Design: one warp per lane,
// kTbLanes lanes per block.  The warp stages the lane's word rows (all W
// columns of 16 rows) in shared memory, NS of them (8, 4, 2 at W = 256,
// 512, 1024: 8 KB a lane), each copied by cp.async NS-1 rows ahead of the walk, so a
// step's dependent load is a shared-memory load.  At W = 2048 and 4096
// one word row is 8 or 16 KB, and the walk reads the word it needs from
// global memory through the caches instead (NS = 0).  A DIAG run is read off
// one word at once: the count of leading DIAG codes below the current row
// (one __clz) moves the walk down to the next other code or the word's
// end.  Every thread of the warp walks the same path, so control flow
// stays uniform; the moves collect in a 256-byte ring in shared memory
// (a DIAG run written by as many threads) and leave as coalesced
// 128-byte stores.

#include <cstddef>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kStop = 0;
constexpr int kDiag = 1;
constexpr int kUp = 2;
constexpr int kLeft = 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDpLanes = 4;   // DP lanes (warps) per block
constexpr int kTbLanes = 4;   // traceback lanes (warps) per block

// The thread's target bytes t[p .. p+C+2] for four rows starting at row
// offset p (a multiple of 4), packed little-endian into NTW words.
template <int NTW>
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ row,
                                            int p, unsigned (&w)[NTW]) {
  const unsigned* src = reinterpret_cast<const unsigned*>(row + p);
#pragma unroll
  for (int k = 0; k < NTW; ++k) w[k] = __ldg(src + k);
}

// dp_static_kernel's arguments, for the two forms of a lane
#define AGC_DP_PARAMS                                                     \
  const uint8_t *__restrict__ q, const uint8_t *__restrict__ t,           \
      const int32_t *__restrict__ qlen, int B, int NQ, int K, int match,  \
      int mismatch, int gap, int x_drop, int32_t *__restrict__ score,     \
      int32_t *__restrict__ best_i, int32_t *__restrict__ best_j,         \
      int32_t *__restrict__ rows, int32_t *__restrict__ words
#define AGC_DP_ARGS                                                       \
  q, t, qlen, B, NQ, K, match, mismatch, gap, x_drop, score, best_i,      \
      best_j, rows, words

// One lane a warp, W = 256, 512 or 1024.
template <int W>
__device__ __forceinline__ void dp_static_warp(AGC_DP_PARAMS) {
  constexpr int C = W / 32;        // columns per thread
  static_assert(C % 4 == 0, "the warp form takes W = 256, 512 or 1024");
  constexpr int NG = C / 4;        // groups of four columns
  constexpr int NTW = NG + 1;      // window words for 4 rows
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kDpLanes + (threadIdx.x >> 5);
  if (b >= B) return;
  const int j0 = lane * C;
  const uint8_t* qrow = q + (size_t)b * NQ;
  const uint8_t* trow = t + (size_t)b * (NQ + W) + j0;
  int32_t* wrow = words + (size_t)b * (NQ / 16) * W + j0;
  const int ql = qlen[b];

  int H[C];
  unsigned acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;   // row 0 is all zeros
    acc[c] = 0;
  }
  int tbest = 0, trw = 0, tcol = 0;   // this thread's best cell
  int done = NQ;
  int check = K;   // next row of the x_drop check
  unsigned tw[NTW], tn[NTW] = {};
  load_window(trow, 0, tw);
  unsigned qw = __ldg(reinterpret_cast<const unsigned*>(qrow)), qn = 0;

  for (int r0 = 0; r0 < NQ; r0 += 4) {
    if (r0 + 4 < NQ) {        // next step's bases, off the dependent chain
      load_window(trow, r0 + 4, tn);
      qn = __ldg(reinterpret_cast<const unsigned*>(qrow + r0 + 4));
    }
    const int sh = 2 * (r0 & 15);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const unsigned qrep = __byte_perm(qw, 0, rr * 0x1111);
      unsigned eq[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        eq[g] = __vcmpeq4(rr ? __funnelshift_r(tw[g], tw[g + 1], 8 * rr)
                             : tw[g], qrep);
      int up_last = __shfl_down_sync(kFull, H[0], 1);
      if (lane == 31) up_last = kNeg;
      const int bit = sh + 2 * rr;
      int M[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int up = c + 1 < C ? H[c + 1] : up_last;
        const bool hit = (eq[c >> 2] >> (8 * (c & 3))) & 1u;
        const int dv = H[c] + (hit ? match : mismatch);
        const int uv = up + gap;
        const int m = max(dv, uv);
        M[c] = max(m, 0);
        const unsigned dir = m > 0 ? (dv >= uv ? kDiag : kUp) : kStop;
        acc[c] |= dir << bit;
      }
      // gap chain: serial prefix, scan of the thread totals, fix-up
      H[0] = M[0];
#pragma unroll
      for (int c = 1; c < C; ++c) H[c] = max(H[c - 1] + gap, M[c]);
      int x = H[C - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = max(y + gap * C * d, x);
      }
      int carry = __shfl_up_sync(kFull, x, 1);
      if (lane == 0) carry = kNeg;
      int rk = 0;   // row key: score << 5 | (31 - column)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        H[c] = max(carry + gap * (c + 1), H[c]);
        if (H[c] > M[c]) acc[c] |= (unsigned)kLeft << bit;
        rk = max(rk, (H[c] << 5) | (31 - c));
      }
      if ((rk >> 5) > tbest) {
        tbest = rk >> 5;
        trw = r0 + rr + 1;
        tcol = 31 - (rk & 31);
      }
    }
    const int i = r0 + 4;
    if ((i & 15) == 0) {
      int32_t* dst = wrow + (size_t)((i >> 4) - 1) * W;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        reinterpret_cast<int4*>(dst)[g] =
            make_int4((int)acc[4 * g], (int)acc[4 * g + 1],
                      (int)acc[4 * g + 2], (int)acc[4 * g + 3]);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0;
    }
#pragma unroll
    for (int k = 0; k < NTW; ++k) tw[k] = tn[k];
    qw = qn;
    if (i == check && x_drop > 0 && i < NQ) {
      check += K;
      int f = H[0], bb = tbest;
#pragma unroll
      for (int c = 1; c < C; ++c) f = max(f, H[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        f = max(f, __shfl_xor_sync(kFull, f, o));
        bb = max(bb, __shfl_xor_sync(kFull, bb, o));
      }
      if (!(i + 1 <= ql && (bb == 0 || f >= bb - x_drop))) {
        done = i;
        break;
      }
    }
  }

  // largest score, then earliest row, then smallest column
  unsigned long long key =
      ((unsigned long long)(unsigned)tbest << 40) |
      ((unsigned long long)(0xFFFFFu - (unsigned)trw) << 20) |
      (unsigned long long)(0xFFFFFu - (unsigned)(j0 + tcol));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, key, o);
    key = y > key ? y : key;
  }
  if (lane == 0) {
    const int S = (int)(key >> 40);
    score[b] = S;
    best_i[b] = S > 0 ? (int)(0xFFFFFu - (unsigned)((key >> 20) & 0xFFFFFu))
                      : 0;
    best_j[b] = S > 0 ? (int)(0xFFFFFu - (unsigned)(key & 0xFFFFFu)) : 0;
    rows[b] = done;
  }
}

// One lane a block of G = W / 1024 warps, W = 2048 or 4096: warp g runs
// the W = 1024 form on columns [1024 g, 1024 g + 1024); the gap chain's
// carry and the up neighbour cross the warps through shared memory, one
// barrier a row (see the top of the file).
template <int W>
__device__ __forceinline__ void dp_static_group(AGC_DP_PARAMS) {
  constexpr int G = W / 1024;      // warps a lane
  constexpr int C = 32;            // columns per thread
  constexpr int NG = C / 4;
  constexpr int NTW = NG + 1;
  // by row parity, each warp's chain total and first H (before the carry)
  __shared__ int s_pub[2][G][2];
  __shared__ int s_chk[G][2];      // the x_drop test: front and best
  __shared__ unsigned long long s_key[G];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int jl0 = lane * C;        // the thread's first column in the warp
  const int j0 = g * 1024 + jl0;
  const uint8_t* qrow = q + (size_t)b * NQ;
  const uint8_t* trow = t + (size_t)b * (NQ + W) + j0;
  int32_t* wrow = words + (size_t)b * (NQ / 16) * W + j0;
  const int ql = qlen[b];

  int H[C];
  unsigned acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;   // row 0 is all zeros
    acc[c] = 0;
  }
  int up_edge = g < G - 1 ? 0 : kNeg;   // H_{i-1} of the next warp's first
  int tbest = 0, trw = 0, tcol = 0;     // this thread's best cell
  int done = NQ;
  int check = K;   // next row of the x_drop check
  unsigned tw[NTW], tn[NTW] = {};
  load_window(trow, 0, tw);
  unsigned qw = __ldg(reinterpret_cast<const unsigned*>(qrow)), qn = 0;

  for (int r0 = 0; r0 < NQ; r0 += 4) {
    if (r0 + 4 < NQ) {        // next step's bases, off the dependent chain
      load_window(trow, r0 + 4, tn);
      qn = __ldg(reinterpret_cast<const unsigned*>(qrow + r0 + 4));
    }
    const int sh = 2 * (r0 & 15);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const unsigned qrep = __byte_perm(qw, 0, rr * 0x1111);
      unsigned eq[NG];
#pragma unroll
      for (int k = 0; k < NG; ++k)
        eq[k] = __vcmpeq4(rr ? __funnelshift_r(tw[k], tw[k + 1], 8 * rr)
                             : tw[k], qrep);
      int up_last = __shfl_down_sync(kFull, H[0], 1);
      if (lane == 31) up_last = up_edge;
      const int bit = sh + 2 * rr;
      int M[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int up = c + 1 < C ? H[c + 1] : up_last;
        const bool hit = (eq[c >> 2] >> (8 * (c & 3))) & 1u;
        const int dv = H[c] + (hit ? match : mismatch);
        const int uv = up + gap;
        const int m = max(dv, uv);
        M[c] = max(m, 0);
        const unsigned dir = m > 0 ? (dv >= uv ? kDiag : kUp) : kStop;
        acc[c] |= dir << bit;
      }
      // the warp's own gap chain: serial prefix, scan, fix-up
      H[0] = M[0];
#pragma unroll
      for (int c = 1; c < C; ++c) H[c] = max(H[c - 1] + gap, M[c]);
      int x = H[C - 1];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x = max(y + gap * C * d, x);
      }
      const int total = __shfl_sync(kFull, x, 31);
      int carry = __shfl_up_sync(kFull, x, 1);
      if (lane == 0) carry = kNeg;
#pragma unroll
      for (int c = 0; c < C; ++c) H[c] = max(carry + gap * (c + 1), H[c]);
      const int par = (r0 + rr) & 1;
      if (lane == 0) {
        s_pub[par][g][0] = total;
        s_pub[par][g][1] = H[0];
      }
      __syncthreads();   // the row's totals across the group
      int cin = kNeg, my_cin = kNeg;   // final H of column 1024 gg - 1
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        if (gg == g) my_cin = cin;
        if (gg == g + 1) up_edge = max(s_pub[par][gg][1], cin + gap);
        cin = max(s_pub[par][gg][0], cin + gap * 1024);
      }
      int rk = 0;   // row key: score << 5 | (31 - column)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        H[c] = max(my_cin + gap * (jl0 + c + 1), H[c]);
        if (H[c] > M[c]) acc[c] |= (unsigned)kLeft << bit;
        rk = max(rk, (H[c] << 5) | (31 - c));
      }
      if ((rk >> 5) > tbest) {
        tbest = rk >> 5;
        trw = r0 + rr + 1;
        tcol = 31 - (rk & 31);
      }
    }
    const int i = r0 + 4;
    if ((i & 15) == 0) {
      int32_t* dst = wrow + (size_t)((i >> 4) - 1) * W;
#pragma unroll
      for (int k = 0; k < NG; ++k)
        reinterpret_cast<int4*>(dst)[k] =
            make_int4((int)acc[4 * k], (int)acc[4 * k + 1],
                      (int)acc[4 * k + 2], (int)acc[4 * k + 3]);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0;
    }
#pragma unroll
    for (int k = 0; k < NTW; ++k) tw[k] = tn[k];
    qw = qn;
    if (i == check && x_drop > 0 && i < NQ) {
      check += K;
      int f = H[0], bb = tbest;
#pragma unroll
      for (int c = 1; c < C; ++c) f = max(f, H[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        f = max(f, __shfl_xor_sync(kFull, f, o));
        bb = max(bb, __shfl_xor_sync(kFull, bb, o));
      }
      if (lane == 0) {
        s_chk[g][0] = f;
        s_chk[g][1] = bb;
      }
      __syncthreads();   // the lane's front and best across the group
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        f = max(f, s_chk[gg][0]);
        bb = max(bb, s_chk[gg][1]);
      }
      if (!(i + 1 <= ql && (bb == 0 || f >= bb - x_drop))) {
        done = i;
        break;
      }
    }
  }

  // largest score, then earliest row, then smallest column
  unsigned long long key =
      ((unsigned long long)(unsigned)tbest << 40) |
      ((unsigned long long)(0xFFFFFu - (unsigned)trw) << 20) |
      (unsigned long long)(0xFFFFFu - (unsigned)(j0 + tcol));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, key, o);
    key = y > key ? y : key;
  }
  if (lane == 0) s_key[g] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int gg = 0; gg < G; ++gg) key = s_key[gg] > key ? s_key[gg] : key;
    const int S = (int)(key >> 40);
    score[b] = S;
    best_i[b] = S > 0 ? (int)(0xFFFFFu - (unsigned)((key >> 20) & 0xFFFFFu))
                      : 0;
    best_j[b] = S > 0 ? (int)(0xFFFFFu - (unsigned)(key & 0xFFFFFu)) : 0;
    rows[b] = done;
  }
}

// W = 256 .. 1024: one lane a warp, kDpLanes lanes a block; W = 2048 and
// 4096: one lane a block of W / 1024 warps.
template <int W>
__global__ void __launch_bounds__(W > 1024 ? W / 32 : 32 * kDpLanes)
dp_static_kernel(AGC_DP_PARAMS) {
  if constexpr (W > 1024)
    dp_static_group<W>(AGC_DP_ARGS);
  else
    dp_static_warp<W>(AGC_DP_ARGS);
}

// Asynchronous copy of word row g (W words) into slot g mod NS of slots,
// as one cp.async group; an empty group when g < 0, so that the count of
// groups in flight stays NS - 1.
template <int NS>
__device__ __forceinline__ void fetch_word_row(int32_t* slots,
                                               const int32_t* lane_words,
                                               int g, int W, int lane) {
  if (g >= 0) {
    const int32_t* src = lane_words + (size_t)g * W;
    int32_t* dst = slots + (g & (NS - 1)) * W;
    for (int k = 4 * lane; k < W; k += 128)
      __pipeline_memcpy_async(dst + k, src + k, 16);
  }
  __pipeline_commit();
}

// NS word-row slots per lane: the walk reads row g while rows g-1 ..
// g-NS+1 are on their way.
template <int NS>
__global__ void __launch_bounds__(32 * kTbLanes)
tb_static_kernel(const int32_t* __restrict__ words,
                 const int32_t* __restrict__ best_i,
                 const int32_t* __restrict__ best_j, int B, int NW16, int W,
                 int max_steps, int stride, uint8_t* __restrict__ moves,
                 int32_t* __restrict__ n_out, int32_t* __restrict__ si,
                 int32_t* __restrict__ sj) {
  // per lane: NS word rows, then a 256-byte ring of moves
  extern __shared__ int4 s_dyn[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kTbLanes + warp;
  if (b >= B) return;
  int32_t* slots = reinterpret_cast<int32_t*>(s_dyn) + warp * (NS * W + 64);
  unsigned* ring = reinterpret_cast<unsigned*>(slots + NS * W);
  uint8_t* ring8 = reinterpret_cast<uint8_t*>(ring);
  const int32_t* wb = words + (size_t)b * NW16 * W;
  unsigned* mb = reinterpret_cast<unsigned*>(moves + (size_t)b * stride);
  int i = best_i[b];
  int j = best_j[b];
  ring[lane] = 0;
  ring[32 + lane] = 0;
  int g = 0;   // word row being walked
  if (i > 0) {
    g = min((i - 1) >> 4, NW16 - 1);
    if constexpr (NS > 0) {
#pragma unroll
      for (int k = 0; k < NS; ++k)
        fetch_word_row<NS>(slots, wb, g - k, W, lane);
      __pipeline_wait_prior(NS - 1);
    }
  }
  __syncwarp();
  int step = 0;
  while (step < max_steps && i > 0) {
    const int ii = i - 1;
    const int wi = min(ii >> 4, NW16 - 1);
    if (wi != g) {   // one word row down
      if constexpr (NS > 0) {
        __syncwarp();  // slot g is free: start row g - NS into it
        fetch_word_row<NS>(slots, wb, g - NS, W, lane);
        __pipeline_wait_prior(NS - 1);
        __syncwarp();
      }
      g = wi;
    }
    unsigned word;
    if constexpr (NS > 0)
      word = (unsigned)slots[(g & (NS - 1)) * W + min(max(j, 0), W - 1)];
    else
      word = (unsigned)__ldg(wb + (size_t)g * W + min(max(j, 0), W - 1));
    const int s = ii & 15;
    const unsigned cur = (word >> (2 * s)) & 3u;
    if (cur == kStop) break;
    // a DIAG run goes down this word's column to the first other code
    int run = 1;
    if (cur == kDiag) {
      const unsigned x = (word ^ 0x55555555u) << (30 - 2 * s);
      run = min(x ? (int)(__clz(x) >> 1) : s + 1, max_steps - step);
    }
    if (lane < run) ring8[(step + lane) & 255] = (uint8_t)cur;
    const int next = step + run;
    if ((next >> 7) != (step >> 7)) {   // 128 moves complete: store them
      __syncwarp();
      unsigned* half = ring + ((step >> 7) & 1) * 32;
      mb[((step >> 7) << 5) + lane] = half[lane];
      half[lane] = 0;
      __syncwarp();  // the zeroed word before other lanes' byte stores
    }
    step = next;
    if (cur == kLeft) {
      --j;
    } else {
      i -= run;
      if (cur == kUp) ++j;
    }
  }
  // the open block of up to 128 moves
  __syncwarp();
  const int base = (step >> 7) << 5;
  if (base + lane < (step + 3) >> 2)
    mb[base + lane] = ring[((step >> 7) & 1) * 32 + lane];
  __pipeline_wait_prior(0);   // no copy outlives the warp
  if (lane == 0) {
    n_out[b] = step;
    si[b] = i;
    sj[b] = j;
  }
}

template <int NS>
void launch_tb(const int32_t* words, const int32_t* best_i,
               const int32_t* best_j, int B, int NW16, int W, int max_steps,
               int stride, uint8_t* moves, int32_t* n, int32_t* si,
               int32_t* sj, cudaStream_t s) {
  const size_t smem = (size_t)kTbLanes * (NS * W + 64) * sizeof(int32_t);
  tb_static_kernel<NS><<<(B + kTbLanes - 1) / kTbLanes, 32 * kTbLanes, smem,
                         s>>>(words, best_i, best_j, B, NW16, W, max_steps,
                              stride, moves, n, si, sj);
}

template <int W>
void launch_dp(const uint8_t* q, const uint8_t* t, const int32_t* qlen,
               int B, int NQ, int K, int match, int mismatch, int gap,
               int x_drop, int32_t* score, int32_t* best_i, int32_t* best_j,
               int32_t* rows, int32_t* words, cudaStream_t s) {
  const dim3 grid(W > 1024 ? B : (B + kDpLanes - 1) / kDpLanes),
      block(W > 1024 ? W / 32 : 32 * kDpLanes);
  dp_static_kernel<W><<<grid, block, 0, s>>>(q, t, qlen, B, NQ, K, match,
                                             mismatch, gap, x_drop, score,
                                             best_i, best_j, rows, words);
}

int launch_dp_w(int W, const uint8_t* q, const uint8_t* t,
                const int32_t* qlen, int B, int NQ, int K, int match,
                int mismatch, int gap, int x_drop, int32_t* score,
                int32_t* best_i, int32_t* best_j, int32_t* rows,
                int32_t* words, cudaStream_t s) {
  switch (W) {
#define AGC_DP_CASE(w)                                                    \
  case w:                                                                 \
    launch_dp<w>(q, t, qlen, B, NQ, K, match, mismatch, gap, x_drop,      \
                 score, best_i, best_j, rows, words, s);                  \
    return 0;
    AGC_DP_CASE(256)
    AGC_DP_CASE(512)
    AGC_DP_CASE(1024)
    AGC_DP_CASE(2048)
    AGC_DP_CASE(4096)
#undef AGC_DP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int agc_dp_static(int device, const void* q, const void* t, const void* qlen,
                  int B, int NQ, int W, int K, int match, int mismatch,
                  int gap, int x_drop, void* score, void* best_i,
                  void* best_j, void* rows, void* words, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  auto* qq = static_cast<const uint8_t*>(q);
  auto* tt = static_cast<const uint8_t*>(t);
  auto* ql = static_cast<const int32_t*>(qlen);
  auto* sc = static_cast<int32_t*>(score);
  auto* bi = static_cast<int32_t*>(best_i);
  auto* bj = static_cast<int32_t*>(best_j);
  auto* rw = static_cast<int32_t*>(rows);
  auto* wd = static_cast<int32_t*>(words);
  auto s = static_cast<cudaStream_t>(stream);
  const int code = launch_dp_w(W, qq, tt, ql, B, NQ, K, match, mismatch,
                               gap, x_drop, sc, bi, bj, rw, wd, s);
  if (code) return code;
  return (int)cudaGetLastError();
}

int agc_tb_static(int device, const void* words, const void* best_i,
                  const void* best_j, int B, int NW16, int W, int max_steps,
                  int stride, void* moves, void* n, void* si, void* sj,
                  void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  if ((W != 256 && W != 512 && W != 1024 && W != 2048 && W != 4096) ||
      (stride & 3))
    return (int)cudaErrorInvalidValue;
  auto* wd = static_cast<const int32_t*>(words);
  auto* bi = static_cast<const int32_t*>(best_i);
  auto* bj = static_cast<const int32_t*>(best_j);
  auto* mv = static_cast<uint8_t*>(moves);
  auto* nn = static_cast<int32_t*>(n);
  auto* ci = static_cast<int32_t*>(si);
  auto* cj = static_cast<int32_t*>(sj);
  auto s = static_cast<cudaStream_t>(stream);
  // 8 KB of word rows per lane, 32 KB of shared memory per block, up to
  // W = 1024; none past it
  if (W == 256)
    launch_tb<8>(wd, bi, bj, B, NW16, W, max_steps, stride, mv, nn, ci, cj, s);
  else if (W == 512)
    launch_tb<4>(wd, bi, bj, B, NW16, W, max_steps, stride, mv, nn, ci, cj, s);
  else if (W == 1024)
    launch_tb<2>(wd, bi, bj, B, NW16, W, max_steps, stride, mv, nn, ci, cj, s);
  else
    launch_tb<0>(wd, bi, bj, B, NW16, W, max_steps, stride, mv, nn, ci, cj, s);
  return (int)cudaGetLastError();
}

const char* agc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
