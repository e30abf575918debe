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
// cell: per column the running max and the first row reaching it, then the
// largest score, earliest row, smallest column; all zero when the score is
// 0.  Output words (B, NQ/16, W) int32: bits 2s, 2s+1 of word w hold row
// 16w+s+1.
//
// Design: one block per lane, thread j owns band column j, H/bcol/brow in
// registers.  The up neighbour comes from the next thread by a shuffle; the
// last thread of a warp rebuilds it from the next warp's first M of the
// previous row (kept in shared memory): H[32w+32] = max(M[32w+32],
// H[32w+31] + gap).  The row's gap chain is a 5-step shuffle scan inside
// each warp plus a shuffle scan over the warp totals, with one
// __syncthreads per row.  Max-plus over exact integers is associative, so
// this order gives the Pallas kernel's Kogge-Stone result exactly.  16 rows
// of codes collect in a register and leave as one coalesced int32 store.
//
// x_drop is checked per lane every K rows (the Pallas kernel checks per
// 128-lane tile): the lane stays alive iff row i+1 <= qlen and (best == 0
// or max_j H >= best - x_drop).  A dead lane stops; its later words stay
// unwritten.  rows[b] is the number of rows the lane computed.
//
// Bound on an H100: operations.  About 20 int32 operations per cell (the
// serial form of the recurrence) against 2 bits of output per cell, so the
// integer ALUs are the limit, not the 3.35 TB/s of HBM.  This first
// version spends more: the scan costs ~2*log2(W) operations per cell and a
// block barrier per row.
//
// tb_static_kernel replaces traceback_t and traceback_packed_device of
// aligngraph2_tpu/ops/banded_pallas.py.  One thread per lane walks from
// (best_i, best_j): DIAG keeps j, UP goes to (i-1, j+1), LEFT to (i, j-1);
// it stops at STOP, at i == 0 or after max_steps moves, and writes the
// dense moves END->START (zero padded by the caller), the move count and
// the cursor where it stopped.  The current 16-row word is kept in a
// register, so a run of DIAG moves reads memory once per 16 rows.  Bound:
// the latency of one dependent load per word change; a few bytes per step
// leave HBM bandwidth idle.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 28);
constexpr int kStop = 0;
constexpr int kDiag = 1;
constexpr int kUp = 2;
constexpr int kLeft = 3;
constexpr unsigned kFull = 0xffffffffu;

template <int W>
__global__ void __launch_bounds__(W)
dp_static_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ t,
                 const int32_t* __restrict__ qlen, int NQ, int K, int match,
                 int mismatch, int gap, int x_drop,
                 int32_t* __restrict__ score, int32_t* __restrict__ best_i,
                 int32_t* __restrict__ best_j, int32_t* __restrict__ rows,
                 int32_t* __restrict__ words) {
  constexpr int NW = W / 32;
  __shared__ int s_tot[2][NW];   // per-warp scan total, by row parity
  __shared__ int s_m0[2][NW];    // M of each warp's first column, by parity
  __shared__ int s_red[2][NW];   // x_drop: per-warp max of H and bcol
  __shared__ unsigned long long s_key[NW];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const uint8_t* qb = q + (size_t)b * NQ;
  const uint8_t* tb = t + (size_t)b * (NQ + W) + j;
  int32_t* wb = words + (size_t)b * (NQ / 16) * W + j;
  const int ql = qlen[b];

  if (lane == 0) s_m0[0][warp] = 0;   // row 0 is all zeros
  __syncthreads();

  int H = 0, bcol = 0, brow = 0;
  unsigned acc = 0;
  int done = NQ;
  int q_nx = qb[0];
  int t_nx = tb[0];
  for (int i = 1; i <= NQ; ++i) {
    const int p = i & 1;
    const int qc = q_nx;
    const int tc = t_nx;
    if (i < NQ) {            // next row's bases, off the dependent chain
      q_nx = qb[i];
      t_nx = tb[i];
    }
    int up = __shfl_down_sync(kFull, H, 1);
    if (lane == 31)
      up = (warp + 1 < NW) ? max(s_m0[p ^ 1][warp + 1], H + gap) : kNeg;
    const int dv = H + ((tc == qc) ? match : mismatch);
    const int uv = up + gap;
    int M = max(dv, uv);
    int dir = (dv >= uv) ? kDiag : kUp;
    if (M <= 0) {
      M = 0;
      dir = kStop;
    }
    int v = M;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = max(v, y + gap * d);
    }
    if (lane == 31) s_tot[p][warp] = v;
    if (lane == 0) s_m0[p][warp] = M;
    __syncthreads();
    if (NW > 1) {
      int tv = (lane < NW) ? s_tot[p][lane] : kNeg;
#pragma unroll
      for (int d = 1; d < NW; d <<= 1) {
        const int y = __shfl_up_sync(kFull, tv, d);
        if (lane >= d) tv = max(tv, y + gap * 32 * d);
      }
      const int carry = __shfl_sync(kFull, tv, warp > 0 ? warp - 1 : 0);
      if (warp > 0) v = max(v, carry + gap * (lane + 1));
    }
    const int code = (v > M) ? kLeft : dir;
    if (v > bcol) {
      bcol = v;
      brow = i;
    }
    acc |= (unsigned)code << (2 * ((i - 1) & 15));
    if ((i & 15) == 0) {
      wb[(size_t)((i - 1) >> 4) * W] = (int)acc;
      acc = 0;
    }
    H = v;
    if (x_drop > 0 && i % K == 0 && i < NQ) {
      int f = H, bb = bcol;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        f = max(f, __shfl_xor_sync(kFull, f, o));
        bb = max(bb, __shfl_xor_sync(kFull, bb, o));
      }
      if (lane == 0) {
        s_red[0][warp] = f;
        s_red[1][warp] = bb;
      }
      __syncthreads();
      int front = kNeg, best = 0;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        front = max(front, s_red[0][w]);
        best = max(best, s_red[1][w]);
      }
      if (!(i + 1 <= ql && (best == 0 || front >= best - x_drop))) {
        done = i;
        break;
      }
    }
  }

  // largest score, then earliest row, then smallest column
  unsigned long long key =
      ((unsigned long long)(unsigned)bcol << 40) |
      ((unsigned long long)(0xFFFFFu - (unsigned)brow) << 20) |
      (unsigned long long)(0xFFFFFu - (unsigned)j);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(kFull, key, o);
    key = y > key ? y : key;
  }
  if (lane == 0) s_key[warp] = key;
  __syncthreads();
  if (j == 0) {
    unsigned long long k = s_key[0];
    for (int w = 1; w < NW; ++w) k = s_key[w] > k ? s_key[w] : k;
    const int S = (int)(k >> 40);
    score[b] = S;
    best_i[b] = S > 0 ? (int)(0xFFFFFu - (unsigned)((k >> 20) & 0xFFFFFu)) : 0;
    best_j[b] = S > 0 ? (int)(0xFFFFFu - (unsigned)(k & 0xFFFFFu)) : 0;
    rows[b] = done;
  }
}

__global__ void tb_static_kernel(const int32_t* __restrict__ words,
                                 const int32_t* __restrict__ best_i,
                                 const int32_t* __restrict__ best_j, int B,
                                 int NW16, int W, int max_steps,
                                 uint8_t* __restrict__ moves,
                                 int32_t* __restrict__ n_out,
                                 int32_t* __restrict__ si,
                                 int32_t* __restrict__ sj) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* wb = words + (size_t)b * NW16 * W;
  uint8_t* mb = moves + (size_t)b * max_steps;
  const bool packed = (max_steps & 3) == 0;   // rows are 4-byte aligned
  int i = best_i[b];
  int j = best_j[b];
  int step = 0;
  int cw = -1, cj = -1;
  unsigned word = 0, pack = 0;
  while (step < max_steps && i > 0) {
    const int ii = i - 1;
    const int wi = min(ii >> 4, NW16 - 1);
    const int jj = min(max(j, 0), W - 1);
    if (wi != cw || jj != cj) {
      word = (unsigned)wb[(size_t)wi * W + jj];
      cw = wi;
      cj = jj;
    }
    const int cur = (int)((word >> (2 * (ii & 15))) & 3u);
    if (cur == kStop) break;
    if (packed) {
      pack |= (unsigned)cur << (8 * (step & 3));
      if ((step & 3) == 3) {
        *reinterpret_cast<unsigned*>(mb + step - 3) = pack;
        pack = 0;
      }
    } else {
      mb[step] = (uint8_t)cur;
    }
    if (cur == kLeft) {
      --j;
    } else {
      --i;
      if (cur == kUp) ++j;
    }
    ++step;
  }
  if (packed && (step & 3))
    *reinterpret_cast<unsigned*>(mb + (step & ~3)) = pack;
  n_out[b] = step;
  si[b] = i;
  sj[b] = j;
}

template <int W>
void launch_dp(const uint8_t* q, const uint8_t* t, const int32_t* qlen,
               int B, int NQ, int K, int match, int mismatch, int gap,
               int x_drop, int32_t* score, int32_t* best_i, int32_t* best_j,
               int32_t* rows, int32_t* words, cudaStream_t s) {
  dp_static_kernel<W><<<B, W, 0, s>>>(q, t, qlen, NQ, K, match, mismatch,
                                      gap, x_drop, score, best_i, best_j,
                                      rows, words);
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
  switch (W) {
    case 32: launch_dp<32>(qq, tt, ql, B, NQ, K, match, mismatch, gap,
                           x_drop, sc, bi, bj, rw, wd, s); break;
    case 64: launch_dp<64>(qq, tt, ql, B, NQ, K, match, mismatch, gap,
                           x_drop, sc, bi, bj, rw, wd, s); break;
    case 128: launch_dp<128>(qq, tt, ql, B, NQ, K, match, mismatch, gap,
                             x_drop, sc, bi, bj, rw, wd, s); break;
    case 256: launch_dp<256>(qq, tt, ql, B, NQ, K, match, mismatch, gap,
                             x_drop, sc, bi, bj, rw, wd, s); break;
    case 512: launch_dp<512>(qq, tt, ql, B, NQ, K, match, mismatch, gap,
                             x_drop, sc, bi, bj, rw, wd, s); break;
    case 1024: launch_dp<1024>(qq, tt, ql, B, NQ, K, match, mismatch, gap,
                               x_drop, sc, bi, bj, rw, wd, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int agc_tb_static(int device, const void* words, const void* best_i,
                  const void* best_j, int B, int NW16, int W, int max_steps,
                  void* moves, void* n, void* si, void* sj, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0) return 0;
  constexpr int kThreads = 32;
  tb_static_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), static_cast<const int32_t*>(best_i),
      static_cast<const int32_t*>(best_j), B, NW16, W, max_steps,
      static_cast<uint8_t*>(moves), static_cast<int32_t*>(n),
      static_cast<int32_t*>(si), static_cast<int32_t*>(sj));
  return (int)cudaGetLastError();
}

const char* agc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
