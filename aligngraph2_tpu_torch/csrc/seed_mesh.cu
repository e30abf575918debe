// The mesh seeder's candidate histogram and greedy dedup, for Hopper
// (sm_90a).
//
// Built by ops/_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through the plain C functions at the end of this file.  Each
// launches on the stream it is given, allocates nothing and returns
// cudaGetLastError(); the wrappers in parallel/sharded.py allocate the
// outputs and scratch and raise on a nonzero code.  parallel/sharded.py
// also holds the plain torch versions (_seed_reads_ref, which is
// kmer_codes_batch and _seed_block_candidates_ref a strand, and
// _select_read_candidates_ref), which define the semantics.  Integer sums
// wrap as JAX's int32 sums do: they are taken in unsigned arithmetic.
//
// seed_block_kernel replaces kmer_codes_batch followed by
// _seed_block_candidates of aligngraph2_tpu/parallel/sharded.py, for both
// strands of a batch of reads in one launch.  Stream s = 2 * read +
// strand reads q_fwd or q_rev; its position p (p < len - (k - 1)) has the
// code OR_j byte[p + j] << 2 (k - 1 - j) (kmer_codes_batch's shift-or,
// exact for any byte).  Per (stream, index block): lo = the first index
// of sorted_codes[b] not below the code, n = the run of equal codes from
// lo; a position with n = 0 or n > max_occ is dropped (JAX's spill slot);
// its first min(n, occ) occurrences o add 1 and their diagonal
// sorted_pos[b][lo + o] - p + NQ to bin clamp(floor(diag / bin_w), 0,
// nbins - 1) of hist and dsum.  The smoothed bins sm[x] = h[x] + h[x + 1]
// (0 past the end) are ranked as lax.top_k ranks them, by the key sm_h *
// nbins + (nbins - 1 - x): the larger count first, the lower bin among
// equal counts, zero bins last in ascending order.  The T best give cnt =
// sm_h and diag = floor(sm_d / cnt) - NQ (0 where cnt <= 0), written
// straight into the (B, 2, NB, T) layout of the seeder.
//
// Bound on an H100: latency and the card's fill.  The bytes (a block's
// codes and positions, ~1.6 MB, and the reads) are few against the card's
// rate; what a launch costs is each thread's chain of positions, each a
// search of ~200,000 codes, times the waves of blocks.  The design:
//   * the search starts from a directory of each block's codes, made once
//     an index (sharded.seed_directory, (NB, 2^16 + 3) int32): entry h + 1
//     is the first index whose code is not below h << dsh, dsh = 2k - 16,
//     so a code's lower bound lies between entries h + 1 and h + 2 of its
//     h = code >> dsh, a range of ~3 codes at the mesh's blocks (one
//     sector).  A position costs two dependent reads of L2 (the
//     directory's pair, then the range), where a binary search over the
//     block took ~18; a position whose code is not at lo (~98% of them)
//     stops there, and a hit's run ends inside the same range.  Nothing
//     of the block is copied into shared memory, which leaves the SM's
//     L1 to cache the block;
//   * the grid is (C x S, NB), x fastest: a cluster of C blocks
//     (distributed shared memory, sm_90) shares an (index block, stream)
//     and splits its valid positions into C slices where the (block,
//     stream) pairs are too few to fill the card (the 131072 bucket's
//     6 x 16); every block's fixed cost is the zeroing of its bins, so
//     600 index blocks x 64 streams take one block a pair, the blocks of
//     one index block side by side in the launch order, its codes in L2
//     while they run.  The wrapper picks C (sharded.seed_grid);
//   * the histogram of a stream lives in the cluster's first block: the
//     others add to it through distributed shared memory.  Past 19,348
//     bins (hist, dsum and the touched list no longer fit one block's
//     227 KB) it lives in a global scratch the wrapper allocates, nbins x 3
//     int32 a (stream, index block) pair, added to by global atomics and
//     read back through L2 (kGlobal); the wrapper then launches the index
//     blocks in groups whose scratch fits its budget (blk0, the group's
//     first).  The lanes of a
//     warp whose hits fall in one bin (a read's true hits share a
//     diagonal) add once: __match_any_sync on the bin, __reduce_add_sync
//     of the diagonals, one atomicAdd a bin.  The bin is a multiply by a
//     precomputed reciprocal of bin_w (exact for every 32-bit dividend);
//   * the first add to a bin appends it to a list of touched bins, so the
//     top-T rounds scan only the touched bins and the bins just below
//     them (the only ones whose smoothed count is not zero), each round
//     one barrier and the largest key below the last winner.  Nothing is
//     O(nbins) a stream but the first zeroing.
//
// select_candidates_kernel replaces _select_read_candidates of
// aligngraph2_tpu/parallel/sharded.py.  One warp per read.  The wrapper
// passes the stable cnt-descending order (one torch.sort); the kernel
// walks it and keeps candidate i iff cnt >= min_hits and no kept entry
// has the same tid and |gdiag_j - gdiag_i| <= bin_w (an int32 difference
// that wraps; |INT_MIN| stays INT_MIN, as jnp.abs and torch leave it).
// Then mean = float(sum of kept counts, exact in integers) /
// float(max(n_kept, 1)), score = min(max(cnt, alpha * mean), beta * mean)
// in float32, the prune (when asked) keeps score >= prune * best, best
// the largest kept score (0 if an entry was not kept), and the first K
// kept entries in the order give (sel, idx = order[i], score); unused
// slots are (0, 0, 0.0).
//
// Bound on an H100: latency, a read's walk.  The bytes are a few kB a
// read.  The design makes each candidate O(1) and a batch of 32 one step:
//   * the kept entries are a hash table keyed by (tid, bucket), bucket =
//     (uint32)gdiag / (bin_w + 1): a bucket holds at most one kept entry of
//     a tid, since two entries in it lie within bin_w;
//   * a candidate u = (uint32)gdiag is near a kept v iff v - u (mod 2^32)
//     lies in [-bin_w, bin_w] or is 2^31 (|INT_MIN| = INT_MIN).  The arc
//     [u - bin_w, u + bin_w] of 2 bin_w + 1 values meets at most three
//     buckets, those of its two ends and of u, except where it wraps past
//     2^32: the circle's last bucket is short (2^32 mod (bin_w + 1)
//     values), and the arc can cross it whole.  So a candidate probes five
//     buckets: both ends, its own, the last one, and u + 2^31's, and tests
//     the entry it finds in each exactly;
//   * 32 candidates a lane each probe at once, the first slots of their
//     five chains (open addressing) read together; the batch's own order
//     is then settled with ballots: a survivor near no earlier survivor
//     is kept outright, the few that are near one are decided in order
//     against the kept mask (a near matrix over the earlier lanes of the
//     same tid, __match_any_sync and a shuffle each), and the
//     kept ones store themselves at the gap their own bucket's chain
//     ended at (by compare-and-swap from there where two of the batch
//     found the same gap; no two kept entries share a key);
//   * the table (at least twice the candidates, a power of two) is in
//     shared memory up to kSelSharedSlots slots (128 KB, N <= 8192), past
//     that in a global scratch the wrapper allocates (read through L2,
//     a read's table 512 KB at N = 32,768).  The one key the table cannot
//     store, (tid, gdiag) = (-1, -1), all ones like an empty slot, is
//     kept in a flag;
//   * (order index, count) of each kept entry go to a global scratch in
//     order, read by the mean, the prune and the emission.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSeedThreads = 512;
constexpr int kDirBits = 16;        // the directory: 2^16 code ranges
constexpr int kDir = 1 << kDirBits;
constexpr int kMaxCluster = 8;
constexpr int kSelSharedSlots = 1 << 14;   // table slots a read may hold in
                                           // shared memory (128 KB)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;

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

// the first index of a[0 .. n) whose value is above code (n if none)
__device__ __forceinline__ int upper_bound(const int32_t* a, int n,
                                           int code) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] <= code) {
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

// n / d for every 32-bit n by a multiply (Granlund and Montgomery 1994,
// figure 4.1): l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1
struct Div {
  unsigned m;
  int s1, s2;
};

Div make_div(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  Div v;
  v.m = (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  v.s1 = l < 1 ? l : 1;
  v.s2 = l > 1 ? l - 1 : 0;
  return v;
}

__device__ __forceinline__ unsigned udiv(unsigned n, Div d) {
  const unsigned t = __umulhi(d.m, n);
  return (t + ((n - t) >> d.s1)) >> d.s2;
}

// a bin's value: shared memory, or the scratch read through L2 (its adds
// are atomics there)
template <bool kGlobal>
__device__ __forceinline__ int bin_at(const int32_t* p) {
  if constexpr (kGlobal)
    return __ldcg(p);
  else
    return *p;
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSeedThreads)
seed_block_kernel(const uint8_t* __restrict__ q_fwd,
                  const uint8_t* __restrict__ q_rev,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ sorted_codes,
                  const int32_t* __restrict__ sorted_pos,
                  const int32_t* __restrict__ seed_dir, int NQ, int k,
                  int NB, int L, int nbins, Div bin_div, int occ,
                  int max_occ, int T, int C, int dsh, int blk0,
                  int32_t* __restrict__ scratch,
                  int32_t* __restrict__ cnt_out,
                  int32_t* __restrict__ diag_out) {
  extern __shared__ int32_t smem[];   // hist, dsum, touched: nbins each
  __shared__ int n_touched;
  __shared__ long long red[2][kSeedThreads / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // the positions' slice
  const bool lead = rank == 0;                  // holds the histogram
  const int s = blockIdx.x / C, blk = blk0 + blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t* hist =
      kGlobal ? scratch + ((size_t)blockIdx.y * (gridDim.x / C) + s) * 3 *
                              (size_t)nbins
              : smem;
  int32_t* dsum = hist + nbins;
  int32_t* touched = dsum + nbins;
  const int32_t* sc = sorted_codes + (size_t)blk * L;
  const int32_t* sp = sorted_pos + (size_t)blk * L;
  const int32_t* dir = seed_dir + (size_t)blk * (kDir + 3);

  if (lead) {
    for (int x = tid; x < nbins; x += kSeedThreads) {
      hist[x] = 0;
      dsum[x] = 0;
    }
    if (tid == 0) n_touched = 0;
  }
  cluster.sync();   // the zeroed bins
  int32_t* hist_r = kGlobal ? hist : cluster.map_shared_rank(hist, 0);
  int32_t* dsum_r = kGlobal ? dsum : cluster.map_shared_rank(dsum, 0);
  int32_t* touched_r =
      kGlobal ? touched : cluster.map_shared_rank(touched, 0);
  int* n_touched_r = cluster.map_shared_rank(&n_touched, 0);
  const int b = s >> 1;
  const uint8_t* q = ((s & 1) ? q_rev : q_fwd) + (size_t)b * NQ;
  // the valid positions, p < min(NQ - k + 1, len - (k - 1)), in C slices
  const int n_valid = max(min(NQ, __ldg(lens + b)) - (k - 1), 0);
  const int per = (n_valid + C - 1) / C;
  const int p_lo = rank * per;
  const int nv = min(n_valid, p_lo + per);
  for (int base = p_lo; base < nv; base += kSeedThreads) {
    const int p = base + tid;
    int m = 0, lo = 0;
    if (p < nv) {
      unsigned code = 0;
      for (int j = 0; j < k; ++j) code = (code << 2) | __ldg(q + p + j);
      const int c = (int)code;
      // sc[dir[h + 1] - 1] < h << dsh <= c < (h + 1) << dsh <=
      // sc[dir[h + 2]], so lo and the run's end lie in [dir[h + 1],
      // dir[h + 2]]
      const int h = min(max(c >> dsh, -1), kDir);
      const int a = __ldg(dir + h + 1), e = __ldg(dir + h + 2);
      lo = a + lower_bound(sc + a, e - a, c);
      if (lo < e && __ldg(sc + lo) == c) {
        const int n = upper_bound(sc + lo, e - lo, c);
        m = n <= max_occ ? min(n, occ) : 0;
      }
    }
    for (int o = 0; __any_sync(kFull, o < m); ++o) {
      const bool hit = o < m;
      unsigned x = 0;
      int diag = 0;
      if (hit) {
        diag = wadd(wsub(__ldg(sp + lo + o), p), NQ);
        x = diag < 0 ? 0u : min(udiv((unsigned)diag, bin_div),
                                (unsigned)(nbins - 1));
      }
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hit) {
        const unsigned same = __match_any_sync(hits, x);
        const unsigned dsum_add = __reduce_add_sync(same, (unsigned)diag);
        if (lane == __ffs(same) - 1) {
          if (atomicAdd(hist_r + x, __popc(same)) == 0)
            touched_r[atomicAdd(n_touched_r, 1)] = (int)x;
          atomicAdd(dsum_r + x, (int)dsum_add);
        }
      }
    }
  }
  cluster.sync();   // the stream's hits are in the leader's bins
  if (!lead) return;

  const int nt = n_touched;
  const size_t out = ((size_t)s * NB + blk) * T;
  long long last = LLONG_MAX;   // the previous round's winning key
  for (int t = 0; t < T; ++t) {
    long long best = -1;
    for (int i = tid; i < nt; i += kSeedThreads) {
      const int x = bin_at<kGlobal>(touched + i);
      const int h0 = bin_at<kGlobal>(hist + x);
      long long key =
          (long long)(h0 + (x + 1 < nbins ? bin_at<kGlobal>(hist + x + 1)
                                          : 0)) * nbins + (nbins - 1 - x);
      if (key < last) best = max(best, key);
      if (x > 0 && bin_at<kGlobal>(hist + x - 1) == 0) {   // not touched
        key = (long long)h0 * nbins + (nbins - x);
        if (key < last) best = max(best, key);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      best = max(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) red[t & 1][warp] = best;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kSeedThreads / 32; ++w)
      best = max(best, red[t & 1][w]);
    if (best < 0) {   // no bin left with a count: zeros, as top_k's
      for (int r = t + tid; r < T; r += kSeedThreads) {
        cnt_out[out + r] = 0;
        diag_out[out + r] = 0;
      }
      return;
    }
    if (tid == 0) {
      const int x = nbins - 1 - (int)(best % nbins);
      const int h = bin_at<kGlobal>(hist + x) +
                    (x + 1 < nbins ? bin_at<kGlobal>(hist + x + 1) : 0);
      const int d = wadd(bin_at<kGlobal>(dsum + x),
                         x + 1 < nbins ? bin_at<kGlobal>(dsum + x + 1) : 0);
      cnt_out[out + t] = h;
      diag_out[out + t] = wsub(floor_div(d, h), NQ);
    }
    last = best;
  }
}

// whether a kept gdiag gj is within bin_w of gi: the int32 difference
// wraps and |INT_MIN| stays INT_MIN
__device__ __forceinline__ bool near(int gj, int gi, int bin_w) {
  const int d = wsub(gj, gi);
  return d == INT_MIN || (unsigned)d + (unsigned)bin_w <= 2u * bin_w;
}

__device__ __forceinline__ unsigned long long pack(int t, int g) {
  return ((unsigned long long)(unsigned)t << 32) | (unsigned)g;
}

__device__ __forceinline__ unsigned slot_hash(int t, unsigned bucket) {
  unsigned h = (unsigned)t * 0x9e3779b1u ^ (bucket + 0x7f4a7c15u) * 0x85ebca77u;
  h ^= h >> 15;
  h *= 0x2c1b3c6du;
  return h ^ (h >> 13);
}

// the table lives in shared memory, or in global memory read past L1 (the
// warp's own stores and compare-and-swaps land in L2)
template <bool kShared>
__device__ __forceinline__ unsigned long long slot(
    const unsigned long long* table, unsigned i) {
  return kShared ? table[i] : __ldcg(table + i);
}

template <bool kShared>
__global__ void __launch_bounds__(32)
select_candidates_kernel(const int32_t* __restrict__ cnt,
                         const int32_t* __restrict__ tid,
                         const int32_t* __restrict__ gdiag,
                         const int64_t* __restrict__ order, int N,
                         int tid_stride, int K, int min_hits, float alpha,
                         float beta, int bin_w, Div w, int do_prune,
                         float prune, int slots,
                         unsigned long long* __restrict__ scratch,
                         uint8_t* __restrict__ sel,
                         int32_t* __restrict__ idx_out,
                         float* __restrict__ score_out) {
  extern __shared__ unsigned long long table_s[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const int32_t* crow = cnt + (size_t)b * N;
  const int32_t* trow = tid + (size_t)b * tid_stride;
  const int32_t* grow = gdiag + (size_t)b * N;
  const int64_t* orow = order + (size_t)b * N;
  // a read's scratch: (order index, count) of every kept entry, then its
  // table when not in shared memory
  unsigned long long* row = scratch + (size_t)b * (N + (kShared ? 0 : slots));
  int2* aux = reinterpret_cast<int2*>(row);
  unsigned long long* table = kShared ? table_s : row + N;
  const unsigned mask = (unsigned)slots - 1u;
  for (int i = lane; i < slots; i += 32) table[i] = kEmpty;
  __syncwarp();
  const unsigned last_bucket = udiv(0xffffffffu, w);
  bool sentinel = false;   // (-1, -1) kept

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
    bool surv = base + lane < N && c0 >= min_hits;
    unsigned home = 0;   // where the candidate goes if it is kept
    if (surv) {
      const unsigned u = (unsigned)g0;
      const unsigned bk[5] = {udiv(u - (unsigned)bin_w, w), udiv(u, w),
                              udiv(u + (unsigned)bin_w, w), last_bucket,
                              udiv(u ^ 0x80000000u, w)};
      unsigned at[5];
      unsigned long long en[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) at[j] = slot_hash(t0, bk[j]) & mask;
      // the five chains, a slot of each at once, each to tid t0's entry
      // of its bucket or to a gap
      for (unsigned walk = 0x1fu; walk;) {
#pragma unroll
        for (int j = 0; j < 5; ++j)
          if ((walk >> j) & 1u) en[j] = slot<kShared>(table, at[j]);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          if (!((walk >> j) & 1u)) continue;
          if (en[j] == kEmpty) {
            walk &= ~(1u << j);
          } else if ((int)(en[j] >> 32) == t0 &&
                     udiv((unsigned)en[j], w) == bk[j]) {
            surv = surv && !near((int)(unsigned)en[j], g0, bin_w);
            walk &= ~(1u << j);
          } else {
            at[j] = (at[j] + 1) & mask;
          }
        }
      }
      if (sentinel && t0 == -1)   // (-1, -1), in the last bucket
        surv = surv && !near(-1, g0, bin_w);
      // the own bucket's chain ends at a gap unless it holds an entry of
      // t0, which is near: a kept candidate's slot
      home = at[1];
    }
    const unsigned sv = __ballot_sync(kFull, surv);
    unsigned keep = sv;
    if (__popc(sv) > 1) {
      // near[i] for the batch's earlier candidates i of the same tid: a
      // shuffle for each, the lanes walking their own lists in step
      unsigned rest = __match_any_sync(kFull, t0) & ((1u << lane) - 1u);
      unsigned nm = 0;
      while (__any_sync(kFull, rest)) {
        const int i = rest ? __ffs(rest) - 1 : lane;
        const int gi = __shfl_sync(kFull, g0, i);
        if (rest) {
          nm |= (unsigned)near(gi, g0, bin_w) << i;
          rest &= rest - 1;
        }
      }
      unsigned conf = __ballot_sync(kFull, surv && (nm & sv));
      keep = sv & ~conf;
      while (conf) {   // in order, against what is kept before each
        const int j = __ffs(conf) - 1;
        conf &= conf - 1;
        if (!(__shfl_sync(kFull, nm, j) & keep)) keep |= 1u << j;
      }
    }
    // the kept insert themselves: each at its own chain's gap, or, where
    // two of the batch found the same gap, by compare-and-swap from there
    const bool kept = (keep >> lane) & 1u;
    const unsigned long long e = pack(t0, g0);
    const bool store = kept && e != kEmpty;
    const unsigned stores = __ballot_sync(kFull, store);
    const bool clash = store && __popc(__match_any_sync(stores, home)) > 1;
    if (__any_sync(kFull, clash)) {
      if (store)
        for (unsigned i = home;; i = (i + 1) & mask)
          if (atomicCAS(table + i, kEmpty, e) == kEmpty) break;
    } else if (store) {
      table[home] = e;
    }
    if (kept)
      aux[n_kept + __popc(keep & ((1u << lane) - 1u))] = make_int2(o0, c0);
    sentinel |= __any_sync(kFull, kept && e == kEmpty);
    n_kept += __popc(keep);
    __syncwarp();   // the inserts before the next batch's probes
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
    const int j = base + lane;
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

// streams 2 * read + strand; C blocks a cluster (1, 2, 4 or 8); index
// blocks blk0 .. blk0 + nblk - 1 of NB; the bins in the leader's shared
// memory, or, given a scratch (nblk x 2B pairs of 3 x nbins int32), there
int agc_seed_block(int device, const void* q_fwd, const void* q_rev,
                   const void* lens, const void* sorted_codes,
                   const void* sorted_pos, const void* seed_dir, int B,
                   int NQ, int k, int NB, int L, int nbins, int bin_w,
                   int occ, int max_occ, int T, int C, int blk0, int nblk,
                   void* scratch, void* cnt, void* diag, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || k < 1 || k > 15 || NQ < k || NB <= 0 || NB > 65535 ||
      L <= 0 || nbins <= 0 || bin_w <= 0 || T <= 0 || T > nbins ||
      occ < 0 || max_occ < 0 || C < 1 || C > kMaxCluster || (C & (C - 1)) ||
      (long long)2 * B * C > INT_MAX ||
      (long long)(NQ - k + 1) * occ >= (1ll << 30) || blk0 < 0 ||
      nblk <= 0 || blk0 + nblk > NB)
    return (int)cudaErrorInvalidValue;
  const bool global = scratch != nullptr;
  const size_t smem = global ? 0 : 3 * (size_t)nbins * 4;
  auto kernel = global ? seed_block_kernel<true> : seed_block_kernel<false>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * B * C, nblk);
  cfg.blockDim = dim3(kSeedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint8_t*>(q_fwd),
      static_cast<const uint8_t*>(q_rev), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(sorted_codes),
      static_cast<const int32_t*>(sorted_pos),
      static_cast<const int32_t*>(seed_dir), NQ, k, NB, L, nbins,
      make_div((unsigned)bin_w), occ, max_occ, T, C,
      2 * k > kDirBits ? 2 * k - kDirBits : 0, blk0,
      static_cast<int32_t*>(scratch), static_cast<int32_t*>(cnt),
      static_cast<int32_t*>(diag));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// slots: a power of two >= 2N; the table is in shared memory when slots
// <= kSelSharedSlots, else in scratch after each read's N entries
int agc_select_candidates(int device, const void* cnt, const void* tid,
                          const void* gdiag, const void* order, int B, int N,
                          int tid_stride, int K, int min_hits, float alpha,
                          float beta, int bin_w, int do_prune, float prune,
                          int slots, void* scratch, void* sel, void* idx,
                          void* score, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (B <= 0 || N <= 0 || K <= 0 || bin_w < 0 || bin_w > (1 << 30) ||
      slots < 2 * N || (slots & (slots - 1)))
    return (int)cudaErrorInvalidValue;
  const bool in_shared = slots <= kSelSharedSlots;
  const size_t smem = in_shared ? (size_t)slots * 8 : 0;
  const Div w = make_div((unsigned)bin_w + 1u);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const int32_t*>(cnt);
  const auto* t = static_cast<const int32_t*>(tid);
  const auto* g = static_cast<const int32_t*>(gdiag);
  const auto* o = static_cast<const int64_t*>(order);
  auto* sc = static_cast<unsigned long long*>(scratch);
  auto* s = static_cast<uint8_t*>(sel);
  auto* ix = static_cast<int32_t*>(idx);
  auto* f = static_cast<float*>(score);
  if (in_shared) {
    e = cudaFuncSetAttribute(select_candidates_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    select_candidates_kernel<true><<<B, 32, smem, st>>>(
        c, t, g, o, N, tid_stride, K, min_hits, alpha, beta, bin_w, w,
        do_prune, prune, slots, sc, s, ix, f);
  } else {
    select_candidates_kernel<false><<<B, 32, 0, st>>>(
        c, t, g, o, N, tid_stride, K, min_hits, alpha, beta, bin_w, w,
        do_prune, prune, slots, sc, s, ix, f);
  }
  return (int)cudaGetLastError();
}

const char* agc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
