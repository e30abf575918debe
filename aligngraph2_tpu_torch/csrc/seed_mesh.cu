// The mesh seeder's candidate histogram and greedy dedup, for Hopper
// (sm_90a).
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C functions at the end of this file.  Each
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError(); the wrappers in parallel/sharded.py allocate the
// outputs and raise on a nonzero code.  parallel/sharded.py also holds the
// plain torch versions (_seed_block_candidates_ref,
// _select_read_candidates_ref), which define the semantics.  Integer sums
// wrap as JAX's int32 sums do: they are taken in unsigned arithmetic.
//
// seed_block_kernel replaces _seed_block_candidates of
// aligngraph2_tpu/parallel/sharded.py.  One block of kSeedThreads threads
// per (index block, read stream), grid (NB, S).  For each valid query
// position p, the thread finds lo = the first index of sorted_codes[b] not
// below the code (searchsorted, side left) and n = the run of equal codes
// from lo; a position with n = 0 or n > max_occ is dropped (JAX's spill
// slot).  Its first min(n, occ) occurrences o add 1 and their diagonal
// sorted_pos[b][min(lo + o, L - 1)] - p + NQ to bin
// clamp(floor(diag / bin_w), 0, nbins - 1) of hist and dsum.  Then the
// bins are smoothed, sm[x] = h[x] + h[x + 1] (0 past the end), and T
// rounds of a block-wide argmax on the key sm_h * nbins + (nbins - 1 - x)
// pick lax.top_k's bins: the larger count first, the lower bin among
// equal counts, so zero bins come last in ascending order.  Each winner
// writes cnt = sm_h and diag = floor(sm_d / max(cnt, 1)) - NQ (0 where
// cnt <= 0) straight into the (S, NB, T) layout.
//
// Bound on an H100: latency.  The bytes (the block index, ~1.6 MB a block,
// and the query codes) are read in microseconds and sit in L2; the
// operations are a few tens of millions.  What a call costs is each
// thread's chain: its NK / kSeedThreads positions, one after the other,
// each a binary search over ~200,000 codes, ~18 dependent reads.  The
// design keeps that chain short and everything else off it:
//   * every 64th code of the block (12.5 KB at L = 200,052) is copied
//     into shared memory first; the search runs there down to a window
//     of 63 codes, and only the last ~6 steps read the block, within two
//     or three cache lines, so about three dependent L2 reads a
//     position, not 18;
//   * a position whose code is not at lo (about 98% of them on the mesh
//     phase's reads) stops there; the run length is a second binary
//     search over at most max_occ + 1 entries from lo (n is exact up to
//     max_occ, max_occ + 1 past it, which is all the rule reads);
//   * hist and dsum live in shared memory (dynamic, above 48 KB when
//     nbins is large: bin_w = 32 at NQ = 131072 takes 83 KB); the
//     scatter is a shared atomicAdd, whose int32 sum wraps and is the
//     same in any order;
//   * the smoothing is read on the fly by the argmax rounds (no second
//     pass, no second pair of arrays), and a winner is marked in a shared
//     bit set; T rounds of a warp shuffle and one shared exchange each.
//
// select_candidates_kernel replaces _select_read_candidates of
// aligngraph2_tpu/parallel/sharded.py.  One warp per read.  The wrapper
// passes the stable cnt-descending order (torch.sort); the kernel walks
// i = 0 .. N - 1 in it and keeps candidate order[i] iff cnt >= min_hits
// and no kept entry has the same tid and |gdiag_j - gdiag_i| <= bin_w (an
// int32 difference that wraps; |INT_MIN| stays INT_MIN, as jnp.abs and
// torch leave it).  Then mean = float(sum of kept counts, exact in
// integers) / float(max(n_kept, 1)), score = min(max(cnt, alpha * mean),
// beta * mean) in float32, the prune (when asked) keeps score >= prune *
// best, best the largest kept score (0 if an entry was not kept), and the
// first K kept entries in the order give (sel, idx = order[i], score);
// unused slots are (0, 0, 0.0).
//
// Bound on an H100: latency, N dependent steps.  The bytes are a few kB
// a read.  Here a step scans the kept list, O(N * kept) in all; the
// function needs less (a table of the kept entries by tid and gdiag /
// (bin_w + 1) answers a step in four probes), which shows only on lists
// of thousands.  The design shortens a step:
//   * what a step reads of the kept list, (tid, gdiag), is in shared
//     memory, up to kSelCap entries (224 KB), and past that in a global
//     spill the wrapper allocates; (order index, count), read once at
//     the end, go to a global scratch.  Entry j is written and read only
//     by lane j mod 32, so the list needs no barrier;
//   * the 32 lanes scan the list in chunks of 256 entries, eight a lane,
//     with no branch: both stores are whole chunks long, so the eight
//     loads are issued together and the entries past the list are
//     masked by index; a vote (__any_sync) after each chunk stops a
//     candidate near an early entry;
//   * the candidates come 32 at a time, a lane each: the order and the
//     three gathers of the next batch are issued before the current
//     batch is walked, and a ballot of cnt >= min_hits skips the
//     candidates that cannot be kept without a step.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSeedThreads = 512;
constexpr int kSeedShift = 6;   // the search table: every 64th code
constexpr int kScan = 8;        // kept entries a lane reads between votes
constexpr int kChunk = 32 * kScan;
constexpr int kSelCap = 112 * kChunk;   // kept entries a read may hold in
                                        // shared memory (224 KB)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// the first index of a[0 .. n) whose value is not below code (n if none)
__device__ __forceinline__ int lower_bound(const int32_t* a, int n,
                                           int code) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < code) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// floor(a / b) for b > 0 (C's / truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__global__ void __launch_bounds__(kSeedThreads)
seed_block_kernel(const int32_t* __restrict__ q_codes,
                  const uint8_t* __restrict__ q_valid,
                  const int32_t* __restrict__ sorted_codes,
                  const int32_t* __restrict__ sorted_pos, int NK, int NB,
                  int L, int NQ, int nbins, int bin_w, int occ, int max_occ,
                  int T, int32_t* __restrict__ cnt_out,
                  int32_t* __restrict__ diag_out) {
  extern __shared__ int32_t smem[];
  int32_t* hist = smem;
  int32_t* dsum = smem + nbins;
  unsigned* taken = reinterpret_cast<unsigned*>(dsum + nbins);
  int32_t* tab = reinterpret_cast<int32_t*>(taken + ((nbins + 31) >> 5));
  __shared__ long long red[kSeedThreads / 32];

  const int blk = blockIdx.x, s = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int x = tid; x < nbins; x += kSeedThreads) {
    hist[x] = 0;
    dsum[x] = 0;
  }
  for (int x = tid; x < (nbins + 31) >> 5; x += kSeedThreads) taken[x] = 0;
  const int32_t* sc = sorted_codes + (size_t)blk * L;
  const int32_t* sp = sorted_pos + (size_t)blk * L;
  const int ns = ((L - 1) >> kSeedShift) + 1;   // tab[i] = sc[i << 6]
  for (int i = tid; i < ns; i += kSeedThreads)
    tab[i] = __ldg(sc + (i << kSeedShift));
  __syncthreads();

  const int32_t* qc = q_codes + (size_t)s * NK;
  const uint8_t* qv = q_valid + (size_t)s * NK;
  for (int p = tid; p < NK; p += kSeedThreads) {
    if (!qv[p]) continue;
    const int code = qc[p];
    // sc[(i0 - 1) << 6] < code <= sc[i0 << 6], so lo lies in
    // ((i0 - 1) << 6, min(i0 << 6, L)]
    const int i0 = lower_bound(tab, ns, code);
    const int w0 = i0 ? ((i0 - 1) << kSeedShift) + 1 : 0;
    const int w1 = min(i0 << kSeedShift, L);
    const int lo = w0 + lower_bound(sc + w0, w1 - w0, code);
    if (lo == L || __ldg(sc + lo) != code) continue;   // n = 0
    int hi = lo;
    for (int len = min(L - lo, max_occ + 1); len > 0;) {   // sc[hi] > code
      const int half = len >> 1;
      if (__ldg(sc + hi + half) <= code) {
        hi += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    const int n = hi - lo;
    if (n == 0 || n > max_occ) continue;
    const int m = min(n, occ);
    for (int o = 0; o < m; ++o) {
      const int tpos = __ldg(sp + min(lo + o, L - 1));
      const int diag = wadd(wsub(tpos, p), NQ);
      const int x = min(max(floor_div(diag, bin_w), 0), nbins - 1);
      atomicAdd(hist + x, 1);
      atomicAdd(dsum + x, diag);
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    long long best = LLONG_MIN;
    for (int x = tid; x < nbins; x += kSeedThreads) {
      if ((taken[x >> 5] >> (x & 31)) & 1u) continue;
      const int h = wadd(hist[x], x + 1 < nbins ? hist[x + 1] : 0);
      best = max(best, (long long)h * nbins + (nbins - 1 - x));
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      best = max(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kSeedThreads / 32; ++w) best = max(best, red[w]);
      long long r = best % nbins;   // the key's tie part, as a floor mod
      if (r < 0) r += nbins;
      const int x = nbins - 1 - (int)r;
      const int h = wadd(hist[x], x + 1 < nbins ? hist[x + 1] : 0);
      const int d = wadd(dsum[x], x + 1 < nbins ? dsum[x + 1] : 0);
      const size_t o = ((size_t)s * NB + blk) * T + t;
      cnt_out[o] = h;
      diag_out[o] = h > 0 ? wsub(floor_div(d, h), NQ) : 0;
      taken[x >> 5] |= 1u << (x & 31);
    }
    __syncthreads();
  }
}

// |a - b| in int32 with wrap; |INT_MIN| stays INT_MIN
__device__ __forceinline__ int abs_diff(int a, int b) {
  const int d = wsub(a, b);
  return d < 0 ? (int)(0u - (unsigned)d) : d;
}

// the spill's entries a read: those past kSelCap, in whole chunks
__host__ __device__ __forceinline__ int spill_entries(int N) {
  return N > kSelCap ? (N - kSelCap + kChunk - 1) / kChunk * kChunk : 0;
}

// Whether an entry of list[0 .. n) (entry j read by lane j mod 32) has
// target ti and a diagonal within bin_w of gi; the same on every lane.
// The list's store holds whole chunks: entries past n are read, not used.

__device__ __forceinline__ bool near_any(const int2* list, int n, int ti,
                                         int gi, int bin_w, int lane) {
  for (int j0 = 0; j0 < n; j0 += kChunk) {
    int2 e[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) e[u] = list[j0 + 32 * u + lane];
    bool near = false;
#pragma unroll
    for (int u = 0; u < kScan; ++u)
      near |= (j0 + 32 * u + lane < n) & (e[u].x == ti) &
              (abs_diff(e[u].y, gi) <= bin_w);
    if (__any_sync(kFull, near)) return true;
  }
  return false;
}

__global__ void __launch_bounds__(32)
select_candidates_kernel(const int32_t* __restrict__ cnt,
                         const int32_t* __restrict__ tid,
                         const int32_t* __restrict__ gdiag,
                         const int64_t* __restrict__ order, int N,
                         int tid_stride, int K, int min_hits, float alpha,
                         float beta, int bin_w, int do_prune, float prune,
                         int2* __restrict__ scratch,
                         uint8_t* __restrict__ sel,
                         int32_t* __restrict__ idx_out,
                         float* __restrict__ score_out) {
  extern __shared__ int2 kept_s[];   // (tid, gdiag) of entries < kSelCap
  const int b = blockIdx.x, lane = threadIdx.x;
  const int32_t* crow = cnt + (size_t)b * N;
  const int32_t* trow = tid + (size_t)b * tid_stride;
  const int32_t* grow = gdiag + (size_t)b * N;
  const int64_t* orow = order + (size_t)b * N;
  // a read's scratch: (order index, count) of every entry, then the
  // (tid, gdiag) of the entries past kSelCap, in whole chunks
  int2* aux = scratch + (size_t)b * (N + spill_entries(N));
  int2* spill = aux + N;

  // batch 0's candidates; batch 1's order
  int o0 = lane < N ? (int)orow[lane] : 0;
  int c0 = lane < N ? crow[o0] : 0, t0 = lane < N ? trow[o0] : 0;
  int g0 = lane < N ? grow[o0] : 0;
  int o1 = 32 + lane < N ? (int)orow[32 + lane] : 0;
  int n_kept = 0;
  for (int base = 0; base < N; base += 32) {
    // the next batch's gathers and the one after's order, issued before
    // this batch is walked
    const bool in1 = base + 32 + lane < N;
    const int c1 = in1 ? crow[o1] : 0, t1 = in1 ? trow[o1] : 0;
    const int g1 = in1 ? grow[o1] : 0;
    const int o2 = base + 64 + lane < N ? (int)orow[base + 64 + lane] : 0;
    unsigned m = __ballot_sync(kFull, base + lane < N && c0 >= min_hits);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const int ti = __shfl_sync(kFull, t0, src);
      const int gi = __shfl_sync(kFull, g0, src);
      const int ci = __shfl_sync(kFull, c0, src);
      const int oi = __shfl_sync(kFull, o0, src);
      const int n_sh = min(n_kept, kSelCap);
      if (near_any(kept_s, n_sh, ti, gi, bin_w, lane) ||
          near_any(spill, n_kept - n_sh, ti, gi, bin_w, lane))
        continue;
      if (lane == (n_kept & 31)) {   // the entry's owner stores it
        const int2 e = make_int2(ti, gi);
        if (n_kept < kSelCap)
          kept_s[n_kept] = e;
        else
          spill[n_kept - kSelCap] = e;
        aux[n_kept] = make_int2(oi, ci);
      }
      ++n_kept;
    }
    o0 = o1;
    c0 = c1;
    t0 = t1;
    g0 = g1;
    o1 = o2;
  }

  long long sum = 0;
  for (int j = lane; j < n_kept; j += 32) sum += aux[j].y;
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  const float mean = (float)sum / (float)max(n_kept, 1);
  const float lo = alpha * mean, hi = beta * mean;
  float thr = 0.f;
  if (do_prune) {
    // the largest of where(kept, score, 0) over all N entries
    float best = n_kept < N ? 0.f : -__int_as_float(0x7f800000);   // -inf
    for (int j = lane; j < n_kept; j += 32)
      best = fmaxf(best, fminf(fmaxf((float)aux[j].y, lo), hi));
#pragma unroll
    for (int off = 16; off; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFull, best, off));
    thr = prune * best;
  }
  uint8_t* srow = sel + (size_t)b * K;
  int32_t* irow = idx_out + (size_t)b * K;
  float* frow = score_out + (size_t)b * K;
  int picked = 0;
  for (int base = 0; base < n_kept && picked < K; base += 32) {
    const int j = base + lane;   // lane j mod 32 owns entry j
    bool keep = false;
    int oi = 0;
    float sc = 0.f;
    if (j < n_kept) {
      const int2 e = aux[j];
      sc = fminf(fmaxf((float)e.y, lo), hi);
      keep = !do_prune || sc >= thr;
      oi = e.x;
    }
    const unsigned m = __ballot_sync(kFull, keep);
    const int r = picked + __popc(m & ((1u << lane) - 1u));
    if (keep && r < K) {
      srow[r] = 1;
      irow[r] = oi;
      frow[r] = sc;
    }
    picked += __popc(m);
  }
  for (int r = min(picked, K) + lane; r < K; r += 32) {
    srow[r] = 0;
    irow[r] = 0;
    frow[r] = 0.f;
  }
}

}  // namespace

extern "C" {

int agc_seed_block(int device, const void* q_codes, const void* q_valid,
                   const void* sorted_codes, const void* sorted_pos, int S,
                   int NK, int NB, int L, int NQ, int nbins, int bin_w,
                   int occ, int max_occ, int T, void* cnt,
                   void* diag, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (S <= 0 || NB <= 0 || S > 65535 || NK < 0 || L <= 0 || nbins <= 0 ||
      bin_w <= 0 || T <= 0 || T > nbins || max_occ < 0 ||
      max_occ >= INT_MAX - 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (2 * (size_t)nbins + ((nbins + 31) >> 5) +
                       (((size_t)L - 1) >> kSeedShift) + 1) * 4;
  e = cudaFuncSetAttribute(seed_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  seed_block_kernel<<<dim3(NB, S), kSeedThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q_codes),
      static_cast<const uint8_t*>(q_valid),
      static_cast<const int32_t*>(sorted_codes),
      static_cast<const int32_t*>(sorted_pos), NK, NB, L, NQ, nbins, bin_w,
      occ, max_occ, T, static_cast<int32_t*>(cnt),
      static_cast<int32_t*>(diag));
  return (int)cudaGetLastError();
}

int agc_select_candidates(int device, const void* cnt, const void* tid,
                          const void* gdiag, const void* order, int B, int N,
                          int tid_stride, int K, int min_hits, float alpha,
                          float beta, int bin_w, int do_prune, float prune,
                          void* scratch, void* sel, void* idx,
                          void* score, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  // the shared store in whole chunks
  const size_t smem =
      (size_t)((min(N, kSelCap) + kChunk - 1) / kChunk * kChunk) *
      sizeof(int2);
  e = cudaFuncSetAttribute(select_candidates_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  select_candidates_kernel<<<B, 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(tid),
      static_cast<const int32_t*>(gdiag),
      static_cast<const int64_t*>(order), N, tid_stride, K, min_hits, alpha,
      beta, bin_w, do_prune, prune, static_cast<int2*>(scratch),
      static_cast<uint8_t*>(sel), static_cast<int32_t*>(idx),
      static_cast<float*>(score));
  return (int)cudaGetLastError();
}

const char* agc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
