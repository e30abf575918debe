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
// Design: one warp per lane, kDpLanes lanes per block; thread l owns the
// C = W/32 contiguous columns [lC, lC + C) and keeps their H in registers.
// The drift is read off the previous row's maximum and first argmax, one
// __reduce_max_sync and one __reduce_min_sync a row (needed anyway for the
// best cell).  The shifted predecessors come from the thread's own H and
// three shuffles (the left neighbour's last column, the right neighbour's
// first two), selected by the warp-uniform dc.  The gap chain is a serial
// max-plus prefix over the thread's C columns, a 5-step shuffle scan of
// the thread totals and a fix-up, as in dp_static_kernel: max-plus over
// exact integers is associative, so it equals the Kogge-Stone scan over
// shifts 1 .. W/2, which reach every distance below W.  The band's target
// bytes move by 0 to 2 positions a row, so every 32 rows the warp stages
// the W + 96 bytes those rows can reach in shared memory with 16-byte
// loads (sentinels outside the window), and each row compares four
// columns per __vcmpeq4 against the row's query byte, which one shuffle
// broadcasts from 32 bytes loaded with the window.  A row's W direction
// bytes leave as C-byte stores, contiguous across the warp; its centre is
// kept by thread (i-1) mod 32 and the warp stores 32 centres at once.
// W is 64, 128, 256, 512 or 1024 (C = 2 .. 32).
//
// Bound on an H100: latency.  The operations (about 20 int32 a cell) and
// bytes (one direction byte a cell) of a call are tiny against the card's
// rates at the aligner's batches (a few dozen lanes); each row is a chain
// of dependent warp steps (two reductions, three neighbour shuffles, the
// serial prefix, five scan shuffles and the carry), so a call costs its
// longest lane's rows times that chain.  The design keeps the chain free
// of global loads and of barriers wider than the warp.
//
// tb_adaptive_kernel replaces traceback of aligngraph2_tpu/ops/banded_dp.py.
// It walks from (best_i, best_j): DIAG to (i-1, j + dc), UP to
// (i-1, j + dc + 1), LEFT to (i, j-1), with dc = centers[i] -
// centers[i-1]; it reads dirs row min(i-1, NQ-1) at column j taken by
// JAX's gather rule (a negative j wraps once, then clamps into [0, W)) and
// the centres at min(i, NQ); it stops at STOP, at i == 0 or after
// max_steps moves, and writes the moves END->START (zero padded by the
// caller), the move count and the cursor where it stopped.  Bound: the
// latency of the walk's dependent chain; a few bytes a step leave HBM
// idle.  Design: one warp per lane, kTbLanes lanes per block.  The warp
// stages NS dirs rows (W bytes each, and the row's centre beside it) in
// shared memory, each copied by cp.async NS-1 rows ahead of the walk
// (NS * W up to 8 KB, at least 8 rows), so a step's dependent load is a
// shared-memory load.  Every thread of the warp walks the same path, so
// control flow stays uniform; thread (s/4) mod 32 keeps move s in a
// register word and the warp stores 128 moves at once.

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
constexpr int kTbLanes = 4;    // traceback lanes (warps) per block
constexpr int kStage = 32;     // rows per staged target window

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
  } else {
    static_assert(C == 2, "the kernel takes W = 64 .. 1024");
    *reinterpret_cast<unsigned short*>(dst) = (unsigned short)d[0];
  }
}

// Row maximum and its first column over the warp: each thread passes the
// maximum of its columns and the first of its columns holding it.
__device__ __forceinline__ void row_argmax(int tmax, int tcol, int& rmax,
                                           int& rarg) {
  rmax = __reduce_max_sync(kFull, tmax);
  rarg = (int)__reduce_min_sync(kFull,
                                tmax == rmax ? (unsigned)tcol : 0xffffffffu);
}

template <int W>
__global__ void __launch_bounds__(32 * kDpLanes)
dp_adaptive_kernel(const uint8_t* __restrict__ q,
                   const uint8_t* __restrict__ t,
                   const int32_t* __restrict__ qlen,
                   const int32_t* __restrict__ tlen,
                   const int32_t* __restrict__ c0, int B, int NQ, int NT,
                   int c_hi, int match, int mismatch, int gap, int x_drop,
                   int32_t* __restrict__ score, int32_t* __restrict__ best_i,
                   int32_t* __restrict__ best_j, uint8_t* __restrict__ dirs,
                   int32_t* __restrict__ centers, int32_t* __restrict__ rows,
                   int32_t* __restrict__ c_last) {
  constexpr int C = W / 32;        // columns per thread
  constexpr int NA = (C + 3) / 4;  // words of four target bytes a thread
  constexpr int SPAN = W + 96;     // staged window bytes: 32 rows move it
                                   // by at most 62, plus 16-byte alignment
  __shared__ __align__(16) uint8_t s_win[kDpLanes][SPAN];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kDpLanes + warp;
  if (b >= B) return;
  uint8_t* win = s_win[warp];
  const unsigned* win32 = reinterpret_cast<const unsigned*>(win);
  const int j0 = lane * C;
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

  // row 0: 0 where p = c0 - W/2 + j lies in [0, tlen], else NEG
  int H[C];
  int tmax = kNeg, tcol = 0;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const int p = c - W / 2 + j0 + k;
    H[k] = p >= 0 && p <= tl ? 0 : kNeg;
    if (k == 0 || H[k] > tmax) {
      tmax = H[k];
      tcol = j0 + k;
    }
  }
  int rmax, rarg;
  row_argmax(tmax, tcol, rmax, rarg);
  if (lane == 0) crow[0] = c;

  int best = 0, bi = 0, bj = 0;
  int s = 0;         // window position of win[0]
  unsigned qv = 0;   // query byte of row (block start + lane)
  int ckeep = 0;     // centre of row (block start + lane)
  int i = 0;
  while (i < last_row) {
    ++i;
    const int dc = rmax > 0 ? min(max(rarg - W / 2, -1), 1) : 0;
    c = min(max(c + dc, -W), c_hi);
    const int base = i - 1 + c - W / 2;   // window position of column 0
    const int blk = (i - 1) & (kStage - 1);
    if (blk == 0) {
      // stage the bytes rows i .. i+31 can read, and their query bytes
      s = base & ~15;
      __syncwarp();
      for (int k = lane; k < SPAN / 16; k += 32) {
        const int x = s + 16 * k;   // NT % 16 == 0: all in or all out
        uint4 v = make_uint4(kFull, kFull, kFull, kFull);
        if (x >= 0 && x < NT)
          v = __ldg(reinterpret_cast<const uint4*>(trow + x));
        reinterpret_cast<uint4*>(win)[k] = v;
      }
      qv = i - 1 + lane < NQ ? qrow[i - 1 + lane] : 0u;
      __syncwarp();
    }
    const unsigned qrep = __shfl_sync(kFull, qv, blk) * 0x01010101u;
    const int o = base - s + j0;   // in [0, 77 + W - C]
    const unsigned* wp = win32 + (o >> 2);
    const unsigned sh = 8u * (o & 3);
    unsigned eq[NA];
    {
      unsigned w[NA + 1];
#pragma unroll
      for (int k = 0; k <= NA; ++k) w[k] = wp[k];
#pragma unroll
      for (int k = 0; k < NA; ++k)
        eq[k] = __vcmpeq4(__funnelshift_r(w[k], w[k + 1], sh), qrep);
    }
    // predecessors: E[k] = H_{i-1}[j0 - 1 + k], diag = E[c + 1 + dc],
    // up = E[c + 2 + dc]
    int lft = __shfl_up_sync(kFull, H[C - 1], 1);
    int rt0 = __shfl_down_sync(kFull, H[0], 1);
    int rt1 = __shfl_down_sync(kFull, H[1], 1);
    if (lane == 0) lft = kNeg;
    if (lane == 31) {
      rt0 = kNeg;
      rt1 = kNeg;
    }
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
    for (int k = 1; k < C; ++k) H[k] = max(H[k - 1] + gap, M[k]);
    int x = H[C - 1];
#pragma unroll
    for (int e = 1; e < 32; e <<= 1) {
      const int y = __shfl_up_sync(kFull, x, e);
      if (lane >= e) x = max(y + gap * C * e, x);
    }
    int carry = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) carry = kNeg;
    const int p0 = base + 1 + j0;
    const bool row_ok = i <= ql;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      int h = max(carry + gap * (k + 1), H[k]);
      const unsigned at = 8u * (k & 3);
      if (h > M[k]) d[k >> 2] |= (unsigned)kLeft << at;
      const int p = p0 + k;
      if (!(row_ok && p >= 0 && p <= tl)) {
        h = kNeg;
        d[k >> 2] &= ~(0xffu << at);
      }
      H[k] = h;
      if (k == 0 || h > tmax) {
        tmax = h;
        tcol = j0 + k;
      }
    }
    store_dirs<C>(drow + (size_t)(i - 1) * W, d);
    if (lane == blk) ckeep = c;
    row_argmax(tmax, tcol, rmax, rarg);
    if (rmax > best) {
      best = rmax;
      bi = i;
      bj = rarg;
    }
    const bool dies =
        xd && !(i < ql && (best == 0 || rmax >= best - x_drop));
    if (blk == kStage - 1 || dies || i == last_row) {
      if (lane <= blk) crow[i - blk + lane] = ckeep;
    }
    if (dies) break;
  }
  if (lane == 0) {
    score[b] = best;
    best_i[b] = bi;
    best_j[b] = bj;
    rows[b] = i;
    c_last[b] = c;
  }
}

// Asynchronous copy of dirs row g (W bytes) and centers[g] into slot
// g mod NS, as one cp.async group; an empty group when g < 0, so that the
// count of groups in flight stays NS - 1.
template <int NS>
__device__ __forceinline__ void fetch_dirs_row(uint8_t* slots,
                                               const uint8_t* lane_dirs,
                                               const int32_t* lane_centers,
                                               int g, int W, int lane) {
  if (g >= 0) {
    uint8_t* dst = slots + (size_t)(g & (NS - 1)) * (W + 16);
    const uint8_t* src = lane_dirs + (size_t)g * W;
    for (int k = 16 * lane; k < W; k += 512)
      __pipeline_memcpy_async(dst + k, src + k, 16);
    if (lane == 0) __pipeline_memcpy_async(dst + W, lane_centers + g, 4);
  }
  __pipeline_commit();
}

// NS dirs-row slots per lane: the walk reads row g while rows g-1 ..
// g-NS+1 are on their way.
template <int NS>
__global__ void __launch_bounds__(32 * kTbLanes)
tb_adaptive_kernel(const uint8_t* __restrict__ dirs,
                   const int32_t* __restrict__ centers,
                   const int32_t* __restrict__ best_i,
                   const int32_t* __restrict__ best_j, int B, int NQ, int W,
                   int max_steps, int stride, uint8_t* __restrict__ moves,
                   int32_t* __restrict__ n_out, int32_t* __restrict__ si,
                   int32_t* __restrict__ sj) {
  extern __shared__ int4 s_dyn[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kTbLanes + warp;
  if (b >= B) return;
  const int slot = W + 16;   // a dirs row, then its centre
  uint8_t* slots = reinterpret_cast<uint8_t*>(s_dyn) + (size_t)warp * NS * slot;
  const uint8_t* db = dirs + (size_t)b * NQ * W;
  const int32_t* cb = centers + (size_t)b * (NQ + 1);
  unsigned* mb = reinterpret_cast<unsigned*>(moves + (size_t)b * stride);
  int i = best_i[b];
  int j = best_j[b];
  int g = 0;          // dirs row in the walk's slot
  int cen_hi = 0;     // centers[min(i, NQ)]
  int cen_nq = 0;     // centers[NQ]
  if (i > 0) {
    cen_nq = cb[NQ];
    cen_hi = cb[min(i, NQ)];
    g = min(i - 1, NQ - 1);
#pragma unroll
    for (int k = 0; k < NS; ++k)
      fetch_dirs_row<NS>(slots, db, cb, g - k, W, lane);
    __pipeline_wait_prior(NS - 1);
  }
  __syncwarp();
  unsigned acc = 0;   // moves 4 * (lane + 32 * block) .. + 3
  int step = 0;
  while (step < max_steps && i > 0) {
    const int ii = i - 1;
    const int gi = min(ii, NQ - 1);
    if (gi != g) {   // one row down
      __syncwarp();  // slot g is free: start row g - NS into it
      fetch_dirs_row<NS>(slots, db, cb, g - NS, W, lane);
      __pipeline_wait_prior(NS - 1);
      __syncwarp();
      g = gi;
    }
    const uint8_t* row = slots + (size_t)(g & (NS - 1)) * slot;
    const int jw = j < 0 ? j + W : j;
    const int cur = row[min(max(jw, 0), W - 1)];
    if (cur == kStop) break;
    if (lane == ((step >> 2) & 31)) acc |= (unsigned)cur << (8 * (step & 3));
    ++step;
    if ((step & 127) == 0) {   // 128 moves complete: store them
      mb[(step >> 7) * 32 - 32 + lane] = acc;
      acc = 0;
    }
    if (cur == kLeft) {
      --j;
    } else {
      const int cen_lo =
          ii >= NQ ? cen_nq : *reinterpret_cast<const int32_t*>(row + W);
      j += cen_hi - cen_lo + (cur == kUp);
      --i;
      cen_hi = cen_lo;
    }
  }
  // the open block of up to 128 moves
  if (lane < ((step & 127) + 3) >> 2) mb[(step >> 7) * 32 + lane] = acc;
  __pipeline_wait_prior(0);   // no copy outlives the warp
  if (lane == 0) {
    n_out[b] = step;
    si[b] = i;
    sj[b] = j;
  }
}

template <int W>
void launch_dp(const uint8_t* q, const uint8_t* t, const int32_t* qlen,
               const int32_t* tlen, const int32_t* c0, int B, int NQ, int NT,
               int c_hi, int match, int mismatch, int gap, int x_drop,
               int32_t* score, int32_t* best_i, int32_t* best_j,
               uint8_t* dirs, int32_t* centers, int32_t* rows,
               int32_t* c_last, cudaStream_t s) {
  dp_adaptive_kernel<W><<<(B + kDpLanes - 1) / kDpLanes, 32 * kDpLanes, 0,
                          s>>>(q, t, qlen, tlen, c0, B, NQ, NT, c_hi, match,
                               mismatch, gap, x_drop, score, best_i, best_j,
                               dirs, centers, rows, c_last);
}

template <int NS>
void launch_tb(const uint8_t* dirs, const int32_t* centers,
               const int32_t* best_i, const int32_t* best_j, int B, int NQ,
               int W, int max_steps, int stride, uint8_t* moves, int32_t* n,
               int32_t* si, int32_t* sj, cudaStream_t s) {
  const size_t smem = (size_t)kTbLanes * NS * (W + 16);
  tb_adaptive_kernel<NS><<<(B + kTbLanes - 1) / kTbLanes, 32 * kTbLanes,
                           smem, s>>>(dirs, centers, best_i, best_j, B, NQ,
                                      W, max_steps, stride, moves, n, si, sj);
}

}  // namespace

extern "C" {

int agc_dp_adaptive(int device, const void* q, const void* t,
                    const void* qlen, const void* tlen, const void* c0, int B,
                    int NQ, int NT, int W, int c_hi, int match, int mismatch,
                    int gap, int x_drop, void* score, void* best_i,
                    void* best_j, void* dirs, void* centers, void* rows,
                    void* c_last, void* stream) {
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
#define AGC_DP_CASE(w)                                                      \
  case w:                                                                   \
    launch_dp<w>(qq, tt, ql, tl, cc, B, NQ, NT, c_hi, match, mismatch, gap, \
                 x_drop, sc, bi, bj, dd, ce, rw, cl, s);                    \
    break;
    AGC_DP_CASE(64)
    AGC_DP_CASE(128)
    AGC_DP_CASE(256)
    AGC_DP_CASE(512)
    AGC_DP_CASE(1024)
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
  // up to 8 KB of dirs rows per lane, at least 8 rows: 20-37 KB a block
  switch (W) {
    case 64:
    case 128:
      launch_tb<64>(dd, ce, bi, bj, B, NQ, W, max_steps, stride, mv, nn, ci,
                    cj, s);
      break;
    case 256:
      launch_tb<32>(dd, ce, bi, bj, B, NQ, W, max_steps, stride, mv, nn, ci,
                    cj, s);
      break;
    case 512:
      launch_tb<16>(dd, ce, bi, bj, B, NQ, W, max_steps, stride, mv, nn, ci,
                    cj, s);
      break;
    case 1024:
      launch_tb<8>(dd, ce, bi, bj, B, NQ, W, max_steps, stride, mv, nn, ci,
                   cj, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* agc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
