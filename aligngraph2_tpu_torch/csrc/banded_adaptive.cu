// Adaptive-band Smith-Waterman DP and its traceback, for Hopper (sm_90a).
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C functions at the end of this file.  Each
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError(); the wrappers in ops/banded_dp.py allocate the outputs
// and raise on a nonzero code.  ops/banded_dp.py also holds the plain torch
// versions (banded_align_ref, traceback_ref), which define the semantics.
//
// dp_adaptive_kernel replaces banded_align of aligngraph2_tpu/ops/banded_dp.py
// (_row_kernel under vmap/scan at x_drop == 0, _banded_align_xdrop's
// while_loop at x_drop > 0).  Per lane and DP row i = 1 .. NQ:
//   * the centre c moves by dc = clamp(argmax H_{i-1} - W/2, -1, 1) when
//     max H_{i-1} > 0 (first maximum), else 0, and is clipped to
//     [-W, c_hi]: c_hi = NT at x_drop > 0, the JAX t_pad length
//     NT + 2W + NQ + 4 at x_drop == 0;
//   * cell j reads diag = H_{i-1}[j + dc], up = H_{i-1}[j + dc + 1] (NEG
//     outside the band) and the target byte at window position
//     x = i - 1 + c - W/2 + j (255 outside [0, NT): JAX reads sentinels
//     there, whether its slice start wraps, clamps or lands in t_pad);
//   * M = max(diag + sub, up + gap), STOP where M <= 0, else DIAG if
//     diag + sub >= up + gap, else UP; M clamped at 0; the row's gap chain
//     H[j] = max_k M[j - k] + gap*k; LEFT where it raises the cell
//     strictly;
//   * cells with p = x + 1 outside [0, tlen], or rows past qlen, are NEG
//     and STOP;
//   * the best cell moves only on a strictly larger row maximum (the
//     earliest row wins), at the row's first maximum.
// x_drop > 0: the lane is alive for row i+1 iff i < qlen and (best == 0 or
// max H_i >= best - x_drop); a dead lane's warp stops.  x_drop == 0: rows
// past qlen + 1 leave every H at NEG and the centre still, so the warp
// stops there too.  The kernel writes dirs and centers up to the last row
// it ran (rows[b]) and its final centre (c_last[b]); the wrapper fills the
// later centres (frozen up to the batch's last live row at x_drop > 0,
// zero after it, as the JAX while_loop leaves them) and zeroes dirs first.
//
// Bound on an H100: latency.  The operations (about 20 int32 a cell) and
// bytes (one direction byte a cell) of a call are tiny against the card's
// rates at the aligner's batches (a few dozen lanes, one warp each, one
// warp per scheduler), so a call costs its longest lane's rows times one
// row's dependent chain, and the design shortens that chain:
//   * one warp per lane, kDpLanes lanes per block; thread l owns the
//     C = W/32 contiguous columns [lC, lC + C) and keeps their H in
//     registers;
//   * one warp reduction a row: each cell's packed key h << 10 | (1023 - j)
//     (-1 for a NEG cell) has its maximum at the row maximum's first
//     column, so one __reduce_max_sync gives the drift, the best cell and
//     the x_drop test; a thread's best key is a max tree of depth log2 C.
//     Keys fit int32 while match * NQ < 2^21; past that the wrapper picks
//     the two-reduction form (max, then min column at the max);
//   * what does not depend on the drift is issued while the reduction is
//     in flight: the three neighbour shuffles of H (left neighbour's last
//     column, right neighbour's first two), the query byte's broadcast and
//     the target compares over the C + 2 bytes that cover every drift
//     (__vcmpeq4, four columns a word); the drift then only picks a byte
//     shift (one funnel shift a word) and the predecessors (selects);
//   * the best cell, the x_drop test and the last-row test of row i are
//     settled beside row i + 1's chain: the warp computes row i + 1 and,
//     if row i was the lane's last, drops it before its stores;
//   * the gap chain is a serial max-plus prefix over the thread's C
//     columns, a 5-step shuffle scan of the thread totals and a fix-up, as
//     in dp_static_kernel (max-plus over exact integers is associative, so
//     it equals the Kogge-Stone scan over shifts 1 .. W/2), each max-plus
//     step one DPX instruction (__viaddmax_s32);
//   * no row waits on device memory: the band's target bytes move by 0 to
//     2 positions a row, so at the start of every 32-row stage the warp
//     fetches, by cp.async into the second of two shared buffers, the
//     W + 160 bytes the next stage's rows can reach (sentinels stored
//     outside the window), and the query bytes of the next stage into a
//     register; a stage waits only on the copy issued 32 rows before;
//   * a row's W direction bytes leave as C-byte stores, contiguous across
//     the warp; its centre is kept by thread (i-1) mod 32 and the warp
//     stores 32 centres at once.
// What is left of a row (about 400 instructions at W = 256, one warp to a
// scheduler, no other warp to hide its latencies; the shuffle scan is the
// longest part) is what bounds the kernel now: PERF.md has its cycles a
// row and the variants that did not pay.
// W is a power of two from 16 to 4096.  W = 64 .. 1024 take the form above
// (C = 2 .. 32).  W = 32 and 16 take it with one column a thread (C = 1);
// at W = 16 lanes 16 .. 31 hold no column: their cells are NEG, so they
// take no part in the reductions, and they store nothing.  W = 2048 and
// 4096 (dp_group) give a lane G = W / 1024 warps, one block: warp g owns
// columns [1024 g, 1024 g + 1024) as the W = 1024 form owns its row (its
// own staged window, 32 columns a thread in registers), and what crosses
// the warps goes through shared memory with one barrier a row.  Before
// the barrier each warp publishes its gap chain's total T_g (the chain's
// value at its last column, from its own columns alone), its own cells'
// best key (or maximum and first column) and its first two H values;
// after it every warp reads all G: the carry into warp g is C_g =
// max(T_{g-1}, C_{g-1} + 1024 gap) (the final H of column 1024 g - 1), a
// warp's best after the carry is its own best or the carry term at its
// first live column (the term falls along the row, so that column holds
// its largest key), the row's best is the best of the G, and the
// neighbours across the warp edges are read off C_g and the published
// values.  The row key takes log2 W column bits at these widths.
//
// tb_adaptive_kernel replaces traceback of aligngraph2_tpu/ops/banded_dp.py.
// It walks from (best_i, best_j): DIAG to (i-1, j + dc), UP to
// (i-1, j + dc + 1), LEFT to (i, j-1), with dc = centers[i] -
// centers[i-1]; it reads dirs row min(i-1, NQ-1) at column j taken by
// JAX's gather rule (a negative j wraps once, then clamps into [0, W)) and
// the centres at min(i, NQ); it stops at STOP, at i == 0 or after
// max_steps moves, and writes the moves END->START (zero padded by the
// caller), the move count and the cursor where it stopped.
// Bound: the latency of the walk's dependent chain; a few bytes a move
// leave HBM idle.  Design: one warp per lane and block.  At W = 2048 and
// 4096 a tile of 32 rows is 64 and 128 KB, too large for a ring of four:
// there (NB = 0) each lane's byte and centres are read from global memory
// through the caches, and nothing is staged.
//   * A warp step reads a whole DIAG run: if the next k + 1 moves are
//     DIAG, move k reads row min(i-1-k, NQ-1) at column j + cen[min(i,NQ)]
//     - cen[min(i-k,NQ)], so lane k reads that byte, __ballot_sync of "not
//     DIAG" and __ffs give the run length r, and the step takes r DIAG
//     moves (cut by max_steps) and the move that ends the run (UP, LEFT or
//     STOP, or row 0), from lane r's byte and columns.
//   * A step reads 32 rows below the walk, so the lane's dirs rows and
//     their centres are staged in tiles of kTile = 32 rows, NB tiles in a
//     shared ring: the tile of the walk's row and the one below are
//     resident, the next NB - 2 below in flight.  Each dirs row is one
//     cp.async.bulk (W bytes) into a row padded to W + 16 bytes, so a
//     run's 32 rows spread over 8 banks; all of a tile's rows complete on
//     one mbarrier; centres by cp.async.  The walk waits once a tile, on a
//     tile fetched NB - 2 tiles earlier.
//   * Moves go to a 256-byte shared ring and leave 128 at a time as 32
//     words, one a thread.

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
constexpr int kDpLanes = 4;    // DP lanes (warps) per block
constexpr int kStage = 32;     // rows per staged target window
// row key: h << key_bits | (2^key_bits - 1 - column), 10 bits up to
// W = 1024, log2 W past it
template <int W>
__host__ __device__ constexpr int key_bits() {
  return W <= 1024 ? 10 : W == 2048 ? 11 : 12;
}
constexpr int kTile = 32;      // dirs rows per traceback tile
constexpr int kRing = 256;     // bytes of the traceback's move ring

// max(a + b, c) in one DPX instruction
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}

// C direction bytes, packed little-endian in d, stored at dst (C bytes,
// aligned to C).
template <int C>
__device__ __forceinline__ void store_dirs(uint8_t* dst,
                                           const unsigned (&d)[(C + 3) / 4]) {
  if constexpr (C % 16 == 0) {
#pragma unroll
    for (int g = 0; g < C / 16; ++g)
      reinterpret_cast<uint4*>(dst)[g] =
          make_uint4(d[4 * g], d[4 * g + 1], d[4 * g + 2], d[4 * g + 3]);
  } else if constexpr (C == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(d[0], d[1]);
  } else if constexpr (C == 4) {
    *reinterpret_cast<unsigned*>(dst) = d[0];
  } else if constexpr (C == 2) {
    *reinterpret_cast<unsigned short*>(dst) = (unsigned short)d[0];
  } else {
    static_assert(C == 1, "C = 1 .. 32 columns a thread");
    *dst = (uint8_t)d[0];
  }
}

// Maximum of N values (N a power of two) as a tree of depth log2 N.
template <int N>
__device__ __forceinline__ int tree_max(const int (&v)[N]) {
  int t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = v[k];
#pragma unroll
  for (int w = 1; w < N; w <<= 1)
#pragma unroll
    for (int k = 0; k + w < N; k += 2 * w) t[k] = max(t[k], t[k + w]);
  return t[0];
}

// The row's warp reduction, issued: PACKED, ra = the warp's largest key;
// else ra = the row maximum and rb its first column.
template <int C, bool PACKED>
__device__ __forceinline__ void row_reduce(const int (&H)[C],
                                           const int (&key)[C], int j0,
                                           int& ra, int& rb) {
  if constexpr (PACKED) {
    ra = __reduce_max_sync(kFull, tree_max(key));
  } else {
    int tmax = H[0], tcol = j0;
#pragma unroll
    for (int k = 1; k < C; ++k)
      if (H[k] > tmax) {
        tmax = H[k];
        tcol = j0 + k;
      }
    ra = __reduce_max_sync(kFull, tmax);
    rb = (int)__reduce_min_sync(kFull,
                                tmax == ra ? (unsigned)tcol : 0xffffffffu);
  }
}

// The row maximum (kNeg for a row of NEG cells) and its first column.
template <int W, bool PACKED>
__device__ __forceinline__ void row_result(int ra, int rb, int& rmax,
                                           int& rarg) {
  if constexpr (PACKED) {
    constexpr int KB = key_bits<W>();
    rmax = ra >= 0 ? ra >> KB : kNeg;
    rarg = ((1 << KB) - 1) - (ra & ((1 << KB) - 1));
  } else {
    rmax = ra;
    rarg = rb;
  }
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The target bytes [s, s + SPAN) of the lane's window into dst as one
// cp.async group: 16-byte copies, 255 stored where a chunk lies outside
// [0, NT) (NT % 16 == 0 and s % 16 == 0: a chunk is all in or all out).
template <int SPAN>
__device__ __forceinline__ void fetch_window(uint8_t* dst,
                                             const uint8_t* trow, int s,
                                             int NT, int lane) {
  for (int k = lane; k < SPAN / 16; k += 32) {
    const int x = s + 16 * k;
    if (x >= 0 && x < NT)
      __pipeline_memcpy_async(dst + 16 * k, trow + x, 16);
    else
      reinterpret_cast<uint4*>(dst)[k] = make_uint4(kFull, kFull, kFull, kFull);
  }
  __pipeline_commit();
}

// dp_adaptive_kernel's arguments, for the two forms of a lane
#define AGC_DP_PARAMS                                                       \
  const uint8_t *__restrict__ q, const uint8_t *__restrict__ t,             \
      const int32_t *__restrict__ qlen, const int32_t *__restrict__ tlen,   \
      const int32_t *__restrict__ c0, int B, int NQ, int NT, int c_hi,      \
      int match, int mismatch, int gap, int x_drop,                         \
      int32_t *__restrict__ score, int32_t *__restrict__ best_i,            \
      int32_t *__restrict__ best_j, uint8_t *__restrict__ dirs,             \
      int32_t *__restrict__ centers, int32_t *__restrict__ rows,            \
      int32_t *__restrict__ c_last
#define AGC_DP_ARGS                                                       \
  q, t, qlen, tlen, c0, B, NQ, NT, c_hi, match, mismatch, gap, x_drop,    \
      score, best_i, best_j, dirs, centers, rows, c_last

// One lane a warp, W = 16 .. 1024.
template <int W, bool PACKED>
__device__ __forceinline__ void dp_warp(AGC_DP_PARAMS) {
  constexpr int C = W >= 32 ? W / 32 : 1;   // columns per thread
  constexpr int NL = W / C;        // threads holding columns (16 at W = 16)
  constexpr int NA = (C + 3) / 4;  // words of four target bytes a thread
  constexpr int kKeyCol = (1 << key_bits<W>()) - 1;
  // staged window bytes: a stage's rows read window positions base_{i-1}
  // .. base_{i-1} + W + 1 (every drift), base_{i-1} at most 126 past the
  // base its fetch was issued at (63 rows of 0-2), plus 16-byte alignment
  // and the word rounding of the reads
  constexpr int SPAN = W + 160;
  __shared__ __align__(16) uint8_t s_win[kDpLanes][2][SPAN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kDpLanes + warp;
  if (b >= B) return;
  // a thread past NL mirrors thread lane - NL's window reads (in the
  // span) and holds only NEG cells
  const int j0 = (lane & (NL - 1)) * C;
  const bool has_cols = NL == 32 || lane < NL;
  const int kc = kKeyCol - j0;     // column j0 + k keys kc - k
  const uint8_t* qrow = q + (size_t)b * NQ;
  const uint8_t* trow = t + (size_t)b * NT;
  uint8_t* drow = dirs + (size_t)b * NQ * W + j0;
  int32_t* crow = centers + (size_t)b * (NQ + 1);
  const int ql = qlen[b];
  const int tl = tlen[b];
  const bool xd = x_drop > 0;
  // x_drop == 0: rows past ql + 1 change nothing but their (still) centre
  const int last_row = xd || ql >= NQ ? NQ : max(ql, 0) + 1;
  int c = c0[b];
  // cw: the centre the window last moved to, c clipped (c0 may lie
  // outside [-W, c_hi]; the clip puts row 1 within one of clip(c0)), so
  // every row moves the window by 0 to 2: base_i = i - 1 + cw_i - W/2
  int cw = min(max(c, -W), c_hi);
  int base = cw - W / 2 - 1;

  // stage 0's window (rows 1 .. 32), and the query bytes of stage 0
  int s_next = base & ~15;
  fetch_window<SPAN>(s_win[warp][0], trow, s_next, NT, lane);
  unsigned qn = lane < NQ ? qrow[lane] : 0u;

  // row 0: 0 where p = c0 - W/2 + j lies in [0, tlen], else NEG
  int H[C];
  int ra, rb = 0;
  {
    int key[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int p = c - W / 2 + j0 + k;
      const bool ok = has_cols && p >= 0 && p <= tl;
      H[k] = ok ? 0 : kNeg;
      key[k] = ok ? kc - k : -1;
    }
    row_reduce<C, PACKED>(H, key, j0, ra, rb);
  }
  int lft = __shfl_up_sync(kFull, H[C - 1], 1);
  int rt0 = __shfl_down_sync(kFull, H[0], 1);
  int rt1 = C > 1 ? __shfl_down_sync(kFull, H[C > 1 ? 1 : 0], 1)
                  : __shfl_down_sync(kFull, H[0], 2);
  if (lane == 0) crow[0] = c;

  int best = 0, bi = 0, bj = 0;
  int s = 0;         // window position of the current stage's win[0]
  unsigned qv = 0;   // query byte of row (stage start + lane + 1)
  int ckeep = 0;     // centre of row (stage start + lane + 1)
  const uint8_t* win = s_win[warp][0];
  int i = 0;         // the last row computed
  while (true) {
    // row i+1, what does not depend on row i's reduction
    const int blk = i & (kStage - 1);
    if (blk == 0) {
      // this stage's window was fetched a stage ago: wait, then fetch the
      // next one into the other buffer, from the current base
      cp_async_wait<0>();
      __syncwarp();
      const int st = i / kStage;
      win = s_win[warp][st & 1];
      s = s_next;
      s_next = base & ~15;
      fetch_window<SPAN>(s_win[warp][(st + 1) & 1], trow, s_next, NT, lane);
      qv = qn;
      const int qx = i + kStage + lane;
      qn = qx < NQ ? qrow[qx] : 0u;
    }
    const unsigned qrep = __shfl_sync(kFull, qv, blk) * 0x01010101u;
    // eqw: target compares from window position base_i + j0, so column
    // j0 + k at drift step d (-1 .. 1) is byte k + 1 + d
    unsigned eqw[NA + 1];
    {
      const int o = base - s + j0;   // in [0, 141 + W - C]
      const unsigned* wp = reinterpret_cast<const unsigned*>(win) + (o >> 2);
      const unsigned sh = 8u * (o & 3);
      unsigned w[NA + 2];
#pragma unroll
      for (int k = 0; k < NA + 2; ++k) w[k] = wp[k];
#pragma unroll
      for (int k = 0; k <= NA; ++k)
        eqw[k] = __vcmpeq4(__funnelshift_r(w[k], w[k + 1], sh), qrep);
    }
    // row i's reduction: the drift, the best cell (row 0's maximum is at
    // most 0, so it never moves it) and whether the lane stops after row
    // i, acted on once row i + 1's chain has been issued
    int rmax, rarg;
    row_result<W, PACKED>(ra, rb, rmax, rarg);
    if (rmax > best) {
      best = rmax;
      bi = i;
      bj = rarg;
    }
    const bool stop =
        i > 0 && (i == last_row ||
                  (xd && !(i < ql && (best == 0 || rmax >= best - x_drop))));
    const int c_row = c;
    ++i;
    const int dc = rmax > 0 ? min(max(rarg - W / 2, -1), 1) : 0;
    const int cn = min(max(c + dc, -W), c_hi);
    const unsigned dsh = 8u * (cn - cw + 1);
    base += 1 + cn - cw;
    cw = cn;
    c = cn;
    unsigned eq[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k) eq[k] = __funnelshift_r(eqw[k], eqw[k + 1], dsh);
    // predecessors: E[k] = H_{i-1}[j0 - 1 + k], diag = E[k + 1 + dc],
    // up = E[k + 2 + dc]
    if (lane == 0) lft = kNeg;
    if (lane == NL - 1) {
      rt0 = kNeg;
      rt1 = kNeg;
    }
    if (C == 1 && lane == NL - 2) rt1 = kNeg;
    int S[C + 1];
#pragma unroll
    for (int k = 0; k <= C; ++k) {
      const int em = k == 0 ? lft : H[k > 0 ? k - 1 : 0];
      const int e0 = k < C ? H[k < C ? k : 0] : rt0;
      const int ep = k + 1 < C ? H[k + 1 < C ? k + 1 : 0]
                               : (k + 1 == C ? rt0 : rt1);
      S[k] = dc < 0 ? em : (dc == 0 ? e0 : ep);
    }
    int M[C];
    unsigned d[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k) d[k] = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const bool hit = (eq[k >> 2] >> (8 * (k & 3))) & 1u;
      const int dv = S[k] + (hit ? match : mismatch);
      const int uv = S[k + 1] + gap;
      const int m = max(dv, uv);
      const unsigned code = m > 0 ? (dv >= uv ? kDiag : kUp) : kStop;
      d[k >> 2] |= code << (8 * (k & 3));
      M[k] = max(m, 0);
    }
    // gap chain: serial prefix, scan of the thread totals, fix-up
    H[0] = M[0];
#pragma unroll
    for (int k = 1; k < C; ++k) H[k] = addmax(H[k - 1], gap, M[k]);
    int x = H[C - 1];
#pragma unroll
    for (int e = 1; e < 32; e <<= 1) {
      const int y = __shfl_up_sync(kFull, x, e);
      if (lane >= e) x = addmax(y, gap * C * e, x);
    }
    int carry = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) carry = kNeg;
    const int p0 = base + 1 + j0;
    const bool row_ok = i <= ql;
    int key[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int h = addmax(carry, gap * (k + 1), H[k]);
      const unsigned at = 8u * (k & 3);
      if (h > M[k]) d[k >> 2] |= (unsigned)kLeft << at;
      const int p = p0 + k;
      const bool ok = has_cols && row_ok && p >= 0 && p <= tl;
      if (!ok) {
        h = kNeg;
        d[k >> 2] &= ~(0xffu << at);
      }
      H[k] = h;
      key[k] = ok ? (h << key_bits<W>()) + kc - k : -1;
    }
    if (stop) {   // row i - 1 was the last: drop row i
      --i;
      c = c_row;
      const int kb = (i - 1) & (kStage - 1);
      if (lane <= kb) crow[i - kb + lane] = ckeep;
      break;
    }
    if (has_cols) store_dirs<C>(drow + (size_t)(i - 1) * W, d);
    if (lane == blk) ckeep = c;
    if (blk == kStage - 1) crow[i - blk + lane] = ckeep;
    // row i's shuffles and reduction, consumed in the next iteration
    lft = __shfl_up_sync(kFull, H[C - 1], 1);
    rt0 = __shfl_down_sync(kFull, H[0], 1);
    rt1 = C > 1 ? __shfl_down_sync(kFull, H[C > 1 ? 1 : 0], 1)
                : __shfl_down_sync(kFull, H[0], 2);
    row_reduce<C, PACKED>(H, key, j0, ra, rb);
  }
  cp_async_wait<0>();   // no copy outlives the warp
  if (lane == 0) {
    score[b] = best;
    best_i[b] = bi;
    best_j[b] = bj;
    rows[b] = i;
    c_last[b] = c;
  }
}

// One lane a block of G = W / 1024 warps, W = 2048 or 4096: warp g runs
// the W = 1024 form on columns [1024 g, 1024 g + 1024), and the row's
// values that cross the warps go through shared memory, one barrier a row
// (see the top of the file).
template <int W, bool PACKED>
__device__ __forceinline__ void dp_group(AGC_DP_PARAMS) {
  constexpr int G = W / 1024;      // warps a lane
  constexpr int C = 32;            // columns per thread
  constexpr int NA = C / 4;
  constexpr int SPAN = 1024 + 160; // a warp's staged window
  constexpr int KB = key_bits<W>();
  constexpr int KCOL = (1 << KB) - 1;
  __shared__ __align__(16) uint8_t s_win[G][2][SPAN];
  // a warp's row, by row parity: its chain's total, its best key (or
  // maximum and first column) and its first two H values
  __shared__ int s_pub[2][G][5];
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int gc = g * 1024;         // the warp's first column
  const int jl0 = lane * C;        // the thread's first, within the warp
  const int j0 = gc + jl0;
  const int kc = KCOL - j0;        // column j0 + k keys kc - k
  const uint8_t* qrow = q + (size_t)b * NQ;
  const uint8_t* trow = t + (size_t)b * NT;
  uint8_t* drow = dirs + (size_t)b * NQ * W + j0;
  int32_t* crow = centers + (size_t)b * (NQ + 1);
  const int ql = qlen[b];
  const int tl = tlen[b];
  const bool xd = x_drop > 0;
  const int last_row = xd || ql >= NQ ? NQ : max(ql, 0) + 1;
  int c = c0[b];
  int cw = min(max(c, -W), c_hi);
  int base = cw - W / 2 - 1;

  // stage 0's window, this warp's part of it (from s + gc)
  int s_next = base & ~15;
  fetch_window<SPAN>(s_win[g][0], trow, s_next + gc, NT, lane);
  unsigned qn = lane < NQ ? qrow[lane] : 0u;

  // row 0: 0 where p = c0 - W/2 + j lies in [0, tlen], else NEG; its
  // maximum is at most 0, so it moves neither the centre nor the best
  auto live0 = [&](int j) {
    const int p = c - W / 2 + j;
    return p >= 0 && p <= tl;
  };
  int H[C];
#pragma unroll
  for (int k = 0; k < C; ++k) H[k] = live0(j0 + k) ? 0 : kNeg;
  int lft = __shfl_up_sync(kFull, H[C - 1], 1);
  int rt0 = __shfl_down_sync(kFull, H[0], 1);
  int rt1 = __shfl_down_sync(kFull, H[1], 1);
  if (lane == 0) lft = g > 0 && live0(gc - 1) ? 0 : kNeg;
  if (lane == 31) {
    rt0 = g < G - 1 && live0(gc + 1024) ? 0 : kNeg;
    rt1 = g < G - 1 && live0(gc + 1025) ? 0 : kNeg;
  }
  if (threadIdx.x == 0) crow[0] = c;

  int best = 0, bi = 0, bj = 0;
  int rmax = 0, rarg = 0;   // the last row's maximum and first column
  int s = 0;                // window position of the stage's win[0]
  unsigned qv = 0;          // query byte of row (stage start + lane + 1)
  int ckeep = 0;            // centre of row (stage start + lane + 1)
  const uint8_t* win = s_win[g][0];
  int i = 0;                // the last row computed
  while (true) {
    const int blk = i & (kStage - 1);
    if (blk == 0) {   // a group's stage: wait for its window, fetch the next
      cp_async_wait<0>();
      __syncwarp();
      const int st = i / kStage;
      win = s_win[g][st & 1];
      s = s_next;
      s_next = base & ~15;
      fetch_window<SPAN>(s_win[g][(st + 1) & 1], trow, s_next + gc, NT,
                         lane);
      qv = qn;
      const int qx = i + kStage + lane;
      qn = qx < NQ ? qrow[qx] : 0u;
    }
    const unsigned qrep = __shfl_sync(kFull, qv, blk) * 0x01010101u;
    unsigned eqw[NA + 1];   // compares from window position base_i + j0
    {
      const int o = base - s + jl0;
      const unsigned* wp = reinterpret_cast<const unsigned*>(win) + (o >> 2);
      const unsigned sh = 8u * (o & 3);
      unsigned w[NA + 2];
#pragma unroll
      for (int k = 0; k < NA + 2; ++k) w[k] = wp[k];
#pragma unroll
      for (int k = 0; k <= NA; ++k)
        eqw[k] = __vcmpeq4(__funnelshift_r(w[k], w[k + 1], sh), qrep);
    }
    ++i;   // row i, from row i - 1's maximum
    const int dc = rmax > 0 ? min(max(rarg - W / 2, -1), 1) : 0;
    const int cn = min(max(c + dc, -W), c_hi);
    const unsigned dsh = 8u * (cn - cw + 1);
    base += 1 + cn - cw;
    cw = cn;
    c = cn;
    unsigned eq[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k) eq[k] = __funnelshift_r(eqw[k], eqw[k + 1], dsh);
    int S[C + 1];
#pragma unroll
    for (int k = 0; k <= C; ++k) {
      const int em = k == 0 ? lft : H[k > 0 ? k - 1 : 0];
      const int e0 = k < C ? H[k < C ? k : 0] : rt0;
      const int ep = k + 1 < C ? H[k + 1 < C ? k + 1 : 0]
                               : (k + 1 == C ? rt0 : rt1);
      S[k] = dc < 0 ? em : (dc == 0 ? e0 : ep);
    }
    int M[C];
    unsigned d[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k) d[k] = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const bool hit = (eq[k >> 2] >> (8 * (k & 3))) & 1u;
      const int dv = S[k] + (hit ? match : mismatch);
      const int uv = S[k + 1] + gap;
      const int m = max(dv, uv);
      const unsigned code = m > 0 ? (dv >= uv ? kDiag : kUp) : kStop;
      d[k >> 2] |= code << (8 * (k & 3));
      M[k] = max(m, 0);
    }
    // the warp's own gap chain: serial prefix, scan, fix-up (unmasked)
    H[0] = M[0];
#pragma unroll
    for (int k = 1; k < C; ++k) H[k] = addmax(H[k - 1], gap, M[k]);
    int x = H[C - 1];
#pragma unroll
    for (int e = 1; e < 32; e <<= 1) {
      const int y = __shfl_up_sync(kFull, x, e);
      if (lane >= e) x = addmax(y, gap * C * e, x);
    }
    const int total = __shfl_sync(kFull, x, 31);
    int carry = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) carry = kNeg;
    const int p0 = base + 1 + j0;
    const bool row_ok = i <= ql;
    int v[C];   // the keys (PACKED), or H with NEG cells (else)
#pragma unroll
    for (int k = 0; k < C; ++k) {
      H[k] = addmax(carry, gap * (k + 1), H[k]);
      const int p = p0 + k;
      const bool ok = row_ok && p >= 0 && p <= tl;
      v[k] = PACKED ? (ok ? (H[k] << KB) + kc - k : -1) : (ok ? H[k] : kNeg);
    }
    int ra, rb = 0;
    row_reduce<C, PACKED>(v, v, j0, ra, rb);
    int* pub = s_pub[i & 1][g];
    if (lane == 0) {
      pub[0] = total;
      pub[1] = ra;
      pub[2] = rb;
      pub[3] = H[0];
      pub[4] = H[1];
    }
    __syncthreads();   // the group's row: every warp's part published
    // live columns [jlo, jhi] of the row
    const int q0 = base + 1;
    const int jlo = row_ok ? max(0, -q0) : W;
    const int jhi = min(W - 1, tl - q0);
    int cin = kNeg;   // the final H of column 1024 gg - 1, unmasked
    int my_cin = kNeg, up0 = kNeg, up1 = kNeg;
    int kbest = -1, mbest = kNeg, abest = 0;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
      const int* pg = s_pub[i & 1][gg];
      const int ggc = gg * 1024;
      int wa = pg[1], wb = pg[2];
      // the carry term along the warp's live columns peaks at the first
      // (the last where gap > 0)
      const int a = max(jlo, ggc), e = min(jhi, ggc + 1023);
      if (gg > 0 && a <= e) {
        const int cs = gap <= 0 ? a : e;
        const int cv = cin + gap * (cs - ggc + 1);
        if constexpr (PACKED) {
          if (cv >= 0) wa = max(wa, (cv << KB) + KCOL - cs);
        } else if (cv > wa || (cv == wa && cs < wb)) {
          wa = cv;
          wb = cs;
        }
      }
      if constexpr (PACKED) {
        kbest = max(kbest, wa);
      } else if (wa > mbest) {
        mbest = wa;
        abest = wb;
      }
      if (gg == g) my_cin = cin;
      if (gg == g + 1) {
        up0 = max(pg[3], cin + gap);
        up1 = max(pg[4], cin + 2 * gap);
      }
      cin = max(pg[0], cin + gap * 1024);
    }
    if constexpr (PACKED) {
      rmax = kbest >= 0 ? kbest >> KB : kNeg;
      rarg = KCOL - (kbest & KCOL);
    } else {
      rmax = mbest;
      rarg = abest;
    }
    // this warp's cells: the carry from the warps before, LEFT, NEG
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int h = addmax(my_cin, gap * (jl0 + k + 1), H[k]);
      const unsigned at = 8u * (k & 3);
      if (h > M[k]) d[k >> 2] |= (unsigned)kLeft << at;
      const int p = p0 + k;
      if (!(row_ok && p >= 0 && p <= tl)) {
        h = kNeg;
        d[k >> 2] &= ~(0xffu << at);
      }
      H[k] = h;
    }
    lft = __shfl_up_sync(kFull, H[C - 1], 1);
    rt0 = __shfl_down_sync(kFull, H[0], 1);
    rt1 = __shfl_down_sync(kFull, H[1], 1);
    auto live = [&](int j) {   // column j of row i
      const int p = q0 + j;
      return row_ok && p >= 0 && p <= tl;
    };
    if (lane == 0) lft = g > 0 && live(gc - 1) ? my_cin : kNeg;
    if (lane == 31) {
      rt0 = g < G - 1 && live(gc + 1024) ? up0 : kNeg;
      rt1 = g < G - 1 && live(gc + 1025) ? up1 : kNeg;
    }
    if (rmax > best) {
      best = rmax;
      bi = i;
      bj = rarg;
    }
    const bool stop =
        i == last_row ||
        (xd && !(i < ql && (best == 0 || rmax >= best - x_drop)));
    store_dirs<C>(drow + (size_t)(i - 1) * W, d);
    if (lane == blk) ckeep = c;
    if (g == 0 && blk == kStage - 1) crow[i - blk + lane] = ckeep;
    if (stop) {   // row i is the lane's last
      if (g == 0 && lane <= blk) crow[i - blk + lane] = ckeep;
      break;
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (threadIdx.x == 0) {
    score[b] = best;
    best_i[b] = bi;
    best_j[b] = bj;
    rows[b] = i;
    c_last[b] = c;
  }
}

// W = 16 .. 1024: one lane a warp, kDpLanes lanes a block; W = 2048 and
// 4096: one lane a block of W / 1024 warps.
template <int W, bool PACKED>
__global__ void __launch_bounds__(W > 1024 ? W / 32 : 32 * kDpLanes)
dp_adaptive_kernel(AGC_DP_PARAMS) {
  if constexpr (W > 1024)
    dp_group<W, PACKED>(AGC_DP_ARGS);
  else
    dp_warp<W, PACKED>(AGC_DP_ARGS);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival on bar that also expects `bytes` of transactions.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Shared memory of tb_adaptive_kernel<W, NB>: NB tiles of kTile dirs rows
// (W + 16 bytes each) and their centres, the move ring, NB mbarriers.
template <int W, int NB>
constexpr size_t tb_smem() {
  return (size_t)NB * kTile * (W + 16) + (size_t)NB * kTile * 4 + kRing +
         (size_t)NB * 8;
}

template <int W, int NB>
__global__ void __launch_bounds__(32)
tb_adaptive_kernel(const uint8_t* __restrict__ dirs,
                   const int32_t* __restrict__ centers,
                   const int32_t* __restrict__ best_i,
                   const int32_t* __restrict__ best_j, int NQ, int max_steps,
                   int stride, uint8_t* __restrict__ moves,
                   int32_t* __restrict__ n_out, int32_t* __restrict__ si,
                   int32_t* __restrict__ sj) {
  constexpr int RS = W + 16;          // a staged dirs row, padded
  constexpr int ROWS = NB * kTile;    // staged rows: row x at x % ROWS
  static_assert(NB == 0 || ((NB & (NB - 1)) == 0 && NB >= 4),
                "NB: 0 (nothing staged) or a power of two >= 4");
  extern __shared__ __align__(128) uint8_t s_dyn[];
  uint8_t* s_dirs = s_dyn;
  int32_t* s_cen = reinterpret_cast<int32_t*>(s_dyn + ROWS * RS);
  unsigned* ring = reinterpret_cast<unsigned*>(s_cen + ROWS);
  uint8_t* ring8 = reinterpret_cast<uint8_t*>(ring);
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring8 + kRing);
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const uint8_t* db = dirs + (size_t)b * NQ * W;
  const int32_t* cb = centers + (size_t)b * (NQ + 1);
  unsigned* mb = reinterpret_cast<unsigned*>(moves + (size_t)b * stride);
  int i = best_i[b];
  int j = best_j[b];
  ring[lane] = 0;
  ring[lane + 32] = 0;
  int u = 0;          // the tile of the walk's dirs row min(i-1, NQ-1)
  int u0 = 0;         // the first tile fetched
  int cen_hi = 0;     // centers[min(i, NQ)]
  int cen_nq = 0;     // centers[NQ]

  // tile v (rows v*kTile ..) into slot v % NB as one cp.async group: each
  // row one bulk copy, all on the slot's mbarrier; its centres by
  // cp.async.  An empty group when v < 0, so that NB - 2 groups stay in
  // flight behind the two resident tiles.
  auto fetch = [&](int v) {
    if (v >= 0) {
      const int r0 = v * kTile;
      const int n = min(kTile, NQ - r0);
      const int slot = v & (NB - 1);
      if (lane == 0) mbar_expect(bar + slot, (unsigned)(n * W));
      __syncwarp();
      if (lane < n) {
        bulk_load(s_dirs + (size_t)(slot * kTile + lane) * RS,
                  db + (size_t)(r0 + lane) * W, W, bar + slot);
        __pipeline_memcpy_async(s_cen + slot * kTile + lane, cb + r0 + lane,
                                4);
      }
    }
    __pipeline_commit();
  };
  // tile v's rows have landed: its slot's ((u0 - v) / NB)-th fill
  auto wait_tile = [&](int v) {
    if (v >= 0)
      mbar_wait(bar + (v & (NB - 1)), ((u0 - v) / (NB > 0 ? NB : 1)) & 1);
  };
  // centers[min(x, NQ)] for x in the resident rows or x >= NQ
  auto cen_at = [&](int x) {
    if constexpr (NB == 0)
      return __ldg(cb + min(x, NQ));
    else
      return x >= NQ ? cen_nq : s_cen[x & (ROWS - 1)];
  };

  const bool walks = i > 0 && max_steps > 0;
  if constexpr (NB == 0) {
    if (i > 0) cen_hi = cb[min(i, NQ)];
  } else if (walks) {
    if (lane < NB) mbar_init(bar + lane, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    __syncwarp();
    cen_nq = cb[NQ];
    cen_hi = cb[min(i, NQ)];
    u0 = u = min(i - 1, NQ - 1) / kTile;
#pragma unroll 1
    for (int k = 0; k < NB; ++k) fetch(u0 - k);
    cp_async_wait<NB - 2>();
    wait_tile(u0);
    wait_tile(u0 - 1);
  }
  __syncwarp();
  int step = 0;
  while (step < max_steps && i > 0) {
    // lane k: move k of a DIAG run, at (i - k, jk); jn the column after it
    const int ik = i - lane;
    const int ca = lane == 0 ? cen_hi : cen_at(max(ik, 0));
    const int cn = cen_at(max(ik - 1, 0));
    const int jk = j + cen_hi - ca;
    const int jn = j + cen_hi - cn;
    const int jw = jk < 0 ? jk + W : jk;
    const int col = min(max(jw, 0), W - 1);
    const int row = max(min(ik - 1, NQ - 1), 0);
    int code = kStop;
    if constexpr (NB == 0) {
      if (ik > 0) code = __ldg(db + (size_t)row * W + col);
    } else {
      code = ik > 0 ? s_dirs[(row & (ROWS - 1)) * RS + col] : kStop;
    }
    const unsigned nd = __ballot_sync(kFull, code != kDiag);
    const int r = nd ? __ffs(nd) - 1 : 32;    // the run's DIAG moves
    const int take = min(r, max_steps - step);
    if (lane < take) ring8[(step + lane) & (kRing - 1)] = kDiag;
    const int src = min(take, 31);
    const int j_t = __shfl_sync(kFull, jk, src);
    const int jn_t = __shfl_sync(kFull, jn, src);
    const int code_t = __shfl_sync(kFull, code, src);
    const int s0 = step;
    step += take;
    i -= take;
    bool end = false;
    if (take < r) {             // max_steps cut the run
      j = j_t;
      end = true;
    } else if (r == 32) {       // 32 DIAG moves: the next run
      cen_hi += j - jn_t;
      j = jn_t;
    } else if (code_t == kStop || step == max_steps) {   // STOP or row 0
      j = j_t;
      end = true;
    } else {                    // the move that ends the run
      if (lane == 0) ring8[step & (kRing - 1)] = (uint8_t)code_t;
      ++step;
      if (code_t == kLeft) {
        cen_hi += j - j_t;
        j = j_t - 1;
      } else {
        cen_hi += j - jn_t;
        j = jn_t + 1;
        --i;
      }
    }
    if ((s0 >> 7) != (step >> 7)) {   // 128 moves complete: store them
      __syncwarp();
      const int o = ((s0 >> 7) & 1) * 32 + lane;
      mb[(s0 >> 7) * 32 + lane] = ring[o];
      ring[o] = 0;
      __syncwarp();
    }
    if (end) break;
    if constexpr (NB > 0) {
      // keep the 32 rows below the walk's row resident
      const int g = min(i - 1, NQ - 1);
      while (i > 0 && g < u * kTile) {
        __syncwarp();   // slot u is free: fetch tile u - NB into it
        fetch(u - NB);
        cp_async_wait<NB - 2>();
        wait_tile(u - 2);
        __syncwarp();
        --u;
      }
    }
  }
  // the open block of up to 128 moves
  __syncwarp();
  if (lane < ((step & 127) + 3) >> 2)
    mb[(step >> 7) * 32 + lane] = ring[((step >> 7) & 1) * 32 + lane];
  if constexpr (NB > 0) {
    if (walks) {   // no copy outlives the block
      cp_async_wait<0>();
      for (int v = max(u - NB + 1, 0); v <= u - 2; ++v) wait_tile(v);
    }
  }
  if (lane == 0) {
    n_out[b] = step;
    si[b] = i;
    sj[b] = j;
  }
}

template <int W>
void launch_dp(bool packed, const uint8_t* q, const uint8_t* t,
               const int32_t* qlen, const int32_t* tlen, const int32_t* c0,
               int B, int NQ, int NT, int c_hi, int match, int mismatch,
               int gap, int x_drop, int32_t* score, int32_t* best_i,
               int32_t* best_j, uint8_t* dirs, int32_t* centers,
               int32_t* rows, int32_t* c_last, cudaStream_t s) {
  const dim3 grid(W > 1024 ? B : (B + kDpLanes - 1) / kDpLanes),
      block(W > 1024 ? W / 32 : 32 * kDpLanes);
  if (packed)
    dp_adaptive_kernel<W, true><<<grid, block, 0, s>>>(
        q, t, qlen, tlen, c0, B, NQ, NT, c_hi, match, mismatch, gap, x_drop,
        score, best_i, best_j, dirs, centers, rows, c_last);
  else
    dp_adaptive_kernel<W, false><<<grid, block, 0, s>>>(
        q, t, qlen, tlen, c0, B, NQ, NT, c_hi, match, mismatch, gap, x_drop,
        score, best_i, best_j, dirs, centers, rows, c_last);
}

template <int W, int NB>
cudaError_t launch_tb(const uint8_t* dirs, const int32_t* centers,
                      const int32_t* best_i, const int32_t* best_j, int B,
                      int NQ, int max_steps, int stride, uint8_t* moves,
                      int32_t* n, int32_t* si, int32_t* sj, cudaStream_t s) {
  constexpr size_t smem = tb_smem<W, NB>();
  const cudaError_t e = cudaFuncSetAttribute(
      tb_adaptive_kernel<W, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  tb_adaptive_kernel<W, NB><<<B, 32, smem, s>>>(
      dirs, centers, best_i, best_j, NQ, max_steps, stride, moves, n, si, sj);
  return cudaSuccess;
}

// The caller's current device, put back when an entry point returns by
// any path: an entry switches to its tensors' card, and the caller's later
// allocations follow the runtime's current device.
struct CallerDevice {
  int device = -1;
  CallerDevice() {
    if (cudaGetDevice(&device) != cudaSuccess) device = -1;
  }
  ~CallerDevice() {
    if (device >= 0) cudaSetDevice(device);
  }
};

}  // namespace

extern "C" {

int agc_dp_adaptive(int device, const void* q, const void* t,
                    const void* qlen, const void* tlen, const void* c0, int B,
                    int NQ, int NT, int W, int c_hi, int match, int mismatch,
                    int gap, int x_drop, int packed, void* score,
                    void* best_i, void* best_j, void* dirs, void* centers,
                    void* rows, void* c_last, void* stream) {
  const CallerDevice caller;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  if (NQ <= 0 || NT <= 0 || (NT & 15)) return (int)cudaErrorInvalidValue;
  auto* qq = static_cast<const uint8_t*>(q);
  auto* tt = static_cast<const uint8_t*>(t);
  auto* ql = static_cast<const int32_t*>(qlen);
  auto* tl = static_cast<const int32_t*>(tlen);
  auto* cc = static_cast<const int32_t*>(c0);
  auto* sc = static_cast<int32_t*>(score);
  auto* bi = static_cast<int32_t*>(best_i);
  auto* bj = static_cast<int32_t*>(best_j);
  auto* dd = static_cast<uint8_t*>(dirs);
  auto* ce = static_cast<int32_t*>(centers);
  auto* rw = static_cast<int32_t*>(rows);
  auto* cl = static_cast<int32_t*>(c_last);
  auto s = static_cast<cudaStream_t>(stream);
  switch (W) {
#define AGC_DP_CASE(w)                                                    \
  case w:                                                                 \
    launch_dp<w>(packed != 0, qq, tt, ql, tl, cc, B, NQ, NT, c_hi, match, \
                 mismatch, gap, x_drop, sc, bi, bj, dd, ce, rw, cl, s);   \
    break;
    AGC_DP_CASE(16)
    AGC_DP_CASE(32)
    AGC_DP_CASE(64)
    AGC_DP_CASE(128)
    AGC_DP_CASE(256)
    AGC_DP_CASE(512)
    AGC_DP_CASE(1024)
    AGC_DP_CASE(2048)
    AGC_DP_CASE(4096)
#undef AGC_DP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int agc_tb_adaptive(int device, const void* dirs, const void* centers,
                    const void* best_i, const void* best_j, int B, int NQ,
                    int W, int max_steps, int stride, void* moves, void* n,
                    void* si, void* sj, void* stream) {
  const CallerDevice caller;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  if (NQ <= 0 || (stride & 3)) return (int)cudaErrorInvalidValue;
  auto* dd = static_cast<const uint8_t*>(dirs);
  auto* ce = static_cast<const int32_t*>(centers);
  auto* bi = static_cast<const int32_t*>(best_i);
  auto* bj = static_cast<const int32_t*>(best_j);
  auto* mv = static_cast<uint8_t*>(moves);
  auto* nn = static_cast<int32_t*>(n);
  auto* ci = static_cast<int32_t*>(si);
  auto* cj = static_cast<int32_t*>(sj);
  auto s = static_cast<cudaStream_t>(stream);
  // NB tiles of 32 rows: 17-134 KB of shared memory a lane; past 1024 a
  // tile is 64 KB or more, and the walk reads global memory (NB = 0)
  switch (W) {
    case 16:
      e = launch_tb<16, 16>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv, nn,
                            ci, cj, s);
      break;
    case 32:
      e = launch_tb<32, 16>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv, nn,
                            ci, cj, s);
      break;
    case 64:
      e = launch_tb<64, 16>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv, nn,
                            ci, cj, s);
      break;
    case 128:
      e = launch_tb<128, 16>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv,
                             nn, ci, cj, s);
      break;
    case 256:
      e = launch_tb<256, 8>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv, nn,
                            ci, cj, s);
      break;
    case 512:
      e = launch_tb<512, 4>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv, nn,
                            ci, cj, s);
      break;
    case 1024:
      e = launch_tb<1024, 4>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv,
                             nn, ci, cj, s);
      break;
    case 2048:
      e = launch_tb<2048, 0>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv,
                             nn, ci, cj, s);
      break;
    case 4096:
      e = launch_tb<4096, 0>(dd, ce, bi, bj, B, NQ, max_steps, stride, mv,
                             nn, ci, cj, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* agc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
