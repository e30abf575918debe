// Native seed-hit enumeration for the seed-extend aligner.
//
// One pass per read chunk: rolling 2-bit k-mer codes over both strands
// (identical to ops/kmer.py kmer_codes_np + io/seqdb.py revcomp_codes),
// dense count/offset table lookup (max_occ masking baked into the count
// table at build time, ops/seedextend.py SeedIndex), and hit expansion
// — emitting only per-HIT arrays (stream id, in-stream query position,
// global target position).  Replaces a dozen 9M-element numpy passes
// with one cache-friendly loop; the downstream candidate binning stays
// in numpy on the ~100x smaller hit arrays.
//
// Copy of aligngraph2_tpu/native/seedhits.cpp without agx_expand, the
// host expansion of the TPU's run-length traceback: the CUDA traceback
// writes dense moves itself.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

using std::size_t;

namespace {
using std::int32_t;
using std::int64_t;
using std::uint16_t;
using std::uint8_t;
}

extern "C" {

// bases: concatenated 0..3 codes of the chunk's reads (forward strand);
// read_start: (n_reads+1) CSR offsets into bases.
// Streams are numbered 2*i (read i forward) and 2*i+1 (read i reverse
// complement), matching the tag order in find_candidates_batch.
// Returns the number of hits written, or -(needed) if cap is too small.
int64_t ags_seed(const uint8_t* bases, const int64_t* read_start,
                 int64_t n_reads, int64_t k,
                 const uint16_t* dense_cnt, const int32_t* dense_off,
                 const int64_t* sorted_pos,
                 int64_t cap,
                 int32_t* out_sid, int32_t* out_qpos, int64_t* out_tpos) {
    const int64_t mask = (k >= 32) ? -1 : ((int64_t)1 << (2 * k)) - 1;
    int64_t n_out = 0;
    int64_t needed = 0;
    std::vector<uint8_t> rc;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t lo = read_start[r], hi = read_start[r + 1];
        const int64_t n = hi - lo;
        if (n < k) continue;
        // reverse complement buffer
        rc.resize((size_t)n);
        for (int64_t i = 0; i < n; ++i)
            rc[(size_t)i] = (uint8_t)(3 - bases[hi - 1 - i]);
        for (int strand = 0; strand < 2; ++strand) {
            const uint8_t* seq = strand == 0 ? bases + lo : rc.data();
            const int32_t sid = (int32_t)(2 * r + strand);
            int64_t code = 0;
            for (int64_t i = 0; i < k - 1; ++i)
                code = ((code << 2) | seq[i]) & mask;
            for (int64_t p = 0; p + k <= n; ++p) {
                code = ((code << 2) | seq[p + k - 1]) & mask;
                const uint16_t c = dense_cnt[code];
                if (c == 0) continue;
                if (n_out + c > cap) {
                    needed += c;
                    continue;
                }
                const int32_t off = dense_off[code];
                for (uint16_t j = 0; j < c; ++j) {
                    out_sid[n_out] = sid;
                    out_qpos[n_out] = (int32_t)p;
                    out_tpos[n_out] = sorted_pos[off + j];
                    ++n_out;
                }
            }
        }
    }
    if (needed > 0) return -(n_out + needed);
    return n_out;
}

// Solid-kmer set: rolling codes over all reads, radix sort, run-length
// abundance histogram, and the reference's exact cutoff rule over the
// dense 4^k table including absent (abundance-0) entries
// (kmer_counter.cpp:58-77 / ops/kmer.py solid_min_abundance_sparse).
// Returns the number of solid codes written to *out_codes (malloc'd,
// ascending; freed with agk_free) and the cutoff via *out_cutoff.
// A cutoff of 0 returns 0 codes with *out_cutoff = 0 — the caller emits
// the full 4^k universe (the reference's degenerate regime).
int64_t agk_solid(const uint8_t* bases, const int64_t* read_start,
                  int64_t n_reads, int64_t k, double threshold,
                  int64_t** out_codes, int64_t* out_cutoff) {
    const uint32_t mask = (uint32_t)(((int64_t)1 << (2 * k)) - 1);
    const int64_t table_size = (int64_t)1 << (2 * k);
    int64_t total = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        int64_t n = read_start[r + 1] - read_start[r];
        if (n >= k) total += n - k + 1;
    }
    std::vector<uint32_t> codes((size_t)total);
    int64_t w = 0;
    for (int64_t r = 0; r < n_reads; ++r) {
        const int64_t lo = read_start[r], hi = read_start[r + 1];
        if (hi - lo < k) continue;
        uint32_t code = 0;
        for (int64_t i = lo; i < lo + k - 1; ++i)
            code = ((code << 2) | bases[i]) & mask;
        for (int64_t i = lo + k - 1; i < hi; ++i) {
            code = ((code << 2) | bases[i]) & mask;
            codes[(size_t)w++] = code;
        }
    }
    // radix sort: two passes of 15 bits (k <= 15 -> 30-bit keys)
    {
        const int BITS = 15;
        const size_t NB = (size_t)1 << BITS;
        std::vector<uint32_t> tmp((size_t)total);
        std::vector<int64_t> cnt(NB);
        uint32_t* src = codes.data();
        uint32_t* dst = tmp.data();
        for (int pass = 0; pass < 2; ++pass) {
            const int shift = pass * BITS;
            std::fill(cnt.begin(), cnt.end(), 0);
            for (int64_t i = 0; i < total; ++i)
                ++cnt[(src[i] >> shift) & (NB - 1)];
            int64_t acc = 0;
            for (size_t b = 0; b < NB; ++b) {
                int64_t c = cnt[b];
                cnt[b] = acc;
                acc += c;
            }
            for (int64_t i = 0; i < total; ++i)
                dst[cnt[(src[i] >> shift) & (NB - 1)]++] = src[i];
            std::swap(src, dst);
        }
        if (src != codes.data()) codes.swap(tmp);
    }
    // run-length scan: abundance histogram over distinct values
    std::vector<std::pair<int64_t, int64_t>> hist;  // (abundance, freq)
    {
        const int64_t DENSE = 4096;
        std::vector<int64_t> dense((size_t)DENSE, 0);
        std::vector<std::pair<int64_t, int64_t>> big;  // rare long runs
        int64_t n_runs = 0;
        int64_t i = 0;
        while (i < total) {
            int64_t j = i + 1;
            while (j < total && codes[(size_t)j] == codes[(size_t)i]) ++j;
            int64_t ab = j - i;
            if (ab < DENSE) {
                ++dense[(size_t)ab];
            } else {
                bool found = false;
                for (auto& e : big)
                    if (e.first == ab) { ++e.second; found = true; break; }
                if (!found) big.push_back({ab, 1});
            }
            ++n_runs;
            i = j;
        }
        int64_t zero_entries = table_size - n_runs;
        if (zero_entries > 0) hist.push_back({0, zero_entries});
        for (int64_t ab = 1; ab < DENSE; ++ab)
            if (dense[(size_t)ab]) hist.push_back({ab, dense[(size_t)ab]});
        for (auto& e : big) hist.push_back(e);
        std::sort(hist.begin(), hist.end());
    }
    // cutoff rule: smallest abundance where the strictly-greater mass
    // fraction of table entries drops to <= threshold
    int64_t cutoff = 0;
    {
        int64_t cum = 0;
        for (auto& e : hist) {
            cum += e.second;
            if (1.0 - (double)cum / (double)table_size <= threshold) {
                cutoff = e.first;
                break;
            }
        }
    }
    *out_cutoff = cutoff;
    if (cutoff == 0) {
        *out_codes = nullptr;
        return 0;
    }
    // collect codes with abundance >= cutoff (ascending)
    int64_t n_solid = 0;
    {
        int64_t i = 0;
        while (i < total) {
            int64_t j = i + 1;
            while (j < total && codes[(size_t)j] == codes[(size_t)i]) ++j;
            if (j - i >= cutoff) ++n_solid;
            i = j;
        }
    }
    int64_t* out = (int64_t*)std::malloc(
        sizeof(int64_t) * (size_t)std::max<int64_t>(n_solid, 1));
    if (!out) return -1;
    int64_t wr = 0;
    {
        int64_t i = 0;
        while (i < total) {
            int64_t j = i + 1;
            while (j < total && codes[(size_t)j] == codes[(size_t)i]) ++j;
            if (j - i >= cutoff) out[wr++] = (int64_t)codes[(size_t)i];
            i = j;
        }
    }
    *out_codes = out;
    return n_solid;
}

void agk_free(int64_t* p) { std::free(p); }

// ---------------------------------------------------------------------
// Per-read candidate binning: bases -> pre-finalize candidate lists.
//
// Production path of find_candidates_batch's hit-expansion + pack/sort/
// unique/smooth/median phase (ops/seedextend.py — the numpy code stays
// as the specification; tests/test_native_seed.py locks equality).  The
// numpy path materializes and argsorts the CHUNK-wide hit stream, whose
// size grows with reads x target-genome size — the superlinear term
// that made the aligner stages superlinear in genome size.
// Here each read's hits live in a small per-read buffer sorted locally,
// so per-read cost is O(hits_per_read log hits_per_read) with a ~30x
// smaller constant, independent of how many other reads are in flight.
//
// Index access: dense count/offset tables when dense_cnt != NULL
// (k <= 13), else a 2*prefix_len-bit prefix offset table over
// sorted_codes (k = 14..16; ranges within a prefix are ~1 entry at
// practical genome sizes, found with equal_range).
//
// Candidate order per read matches the numpy path exactly: forward
// stream first, then reverse, each ascending (tid, diagonal bin).
// Output arrays are malloc'd (freed via ags_bin_free); per-read counts
// go to out_nc.  Returns total candidates, or -1 on allocation failure.

namespace {

struct BinVecs {
    std::vector<int32_t> tid;
    std::vector<uint8_t> fwd;
    std::vector<int64_t> diag;
    std::vector<int32_t> hits;
};

// key packing must mirror ops/seedextend.py find_candidates_batch:
// dbin in the low 25 bits (offset by 1<<24) so key+1 is the adjacent
// diagonal bin for pair smoothing.
constexpr int64_t kB0 = (int64_t)1 << 24;
constexpr int64_t kMAXB = (int64_t)1 << 25;

inline int64_t floordiv(int64_t a, int64_t b) {
    int64_t q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// int(np.median(x)): float64 median truncated toward zero.
inline int64_t median_trunc(std::vector<int64_t>& m) {
    const size_t n = m.size();
    std::nth_element(m.begin(), m.begin() + n / 2, m.end());
    if (n & 1) return m[n / 2];
    const int64_t hi = m[n / 2];
    const int64_t lo = *std::max_element(m.begin(), m.begin() + n / 2);
    return (int64_t)(((double)lo + (double)hi) / 2.0);
}

struct IndexView {
    const uint16_t* dense_cnt;
    const int32_t* dense_off;
    const int32_t* prefix_off;   // size 4^prefix_len + 1 (k > 13 path)
    int64_t prefix_shift;        // 2 * (k - prefix_len)
    const int64_t* sorted_codes;
    const int32_t* sorted_tid;   // per index entry: target id
    const int32_t* sorted_local; // per index entry: target-local pos
    int64_t max_occ;
};

// Thread-local LSD radix co-sort of (key, diag) by key — keys are
// 45-bit local bin keys, 3 passes of 16 bits.  Reused buffers; stable
// (stability is irrelevant here — runs are multisets — but cheap).
struct RadixWs {
    std::vector<int64_t> k2;
    std::vector<int32_t> d2;
    std::vector<int64_t> cnt;
    void sort(std::vector<int64_t>& keys, std::vector<int32_t>& diags) {
        const size_t n = keys.size();
        if (n < 2) return;
        if (n < 2048) {          // small reads: std::sort wins
            std::vector<std::pair<int64_t, int32_t>> tmp(n);
            for (size_t i = 0; i < n; ++i)
                tmp[i] = {keys[i], diags[i]};
            std::sort(tmp.begin(), tmp.end(),
                      [](const std::pair<int64_t, int32_t>& a,
                         const std::pair<int64_t, int32_t>& b) {
                          return a.first < b.first;
                      });
            for (size_t i = 0; i < n; ++i) {
                keys[i] = tmp[i].first;
                diags[i] = tmp[i].second;
            }
            return;
        }
        const int BITS = 16;
        const size_t NB = (size_t)1 << BITS;
        k2.resize(n);
        d2.resize(n);
        cnt.resize(NB);
        int64_t* sk = keys.data();
        int32_t* sd = diags.data();
        int64_t* dk = k2.data();
        int32_t* dd = d2.data();
        for (int pass = 0; pass < 3; ++pass) {
            const int shift = pass * BITS;
            std::fill(cnt.begin(), cnt.end(), 0);
            for (size_t i = 0; i < n; ++i)
                ++cnt[(size_t)((sk[i] >> shift) & (int64_t)(NB - 1))];
            int64_t acc = 0;
            for (size_t b = 0; b < NB; ++b) {
                int64_t c = cnt[b]; cnt[b] = acc; acc += c;
            }
            for (size_t i = 0; i < n; ++i) {
                const int64_t slot =
                    cnt[(size_t)((sk[i] >> shift) & (int64_t)(NB - 1))]++;
                dk[slot] = sk[i];
                dd[slot] = sd[i];
            }
            std::swap(sk, dk);
            std::swap(sd, dd);
        }
        // odd pass count: results live in the workspace buffers
        std::memcpy(keys.data(), sk, n * sizeof(int64_t));
        std::memcpy(diags.data(), sd, n * sizeof(int32_t));
    }
};

// (count, offset) of index entries matching `code`; max_occ-masked.
inline void idx_lookup(const IndexView& ix, int64_t code, int64_t* cnt,
                       int64_t* off) {
    if (ix.dense_cnt) {
        *cnt = ix.dense_cnt[code];   // masking baked in at build
        *off = *cnt ? ix.dense_off[code] : 0;
        return;
    }
    const int64_t p = code >> ix.prefix_shift;
    const int32_t lo = ix.prefix_off[p], hi = ix.prefix_off[p + 1];
    if (lo == hi) { *cnt = 0; return; }
    const int64_t* a = ix.sorted_codes;
    auto r = std::equal_range(a + lo, a + hi, code);
    const int64_t n = r.second - r.first;
    *cnt = (n > ix.max_occ) ? 0 : n;
    *off = r.first - a;
}

void bin_reads_range(const uint8_t* bases, const int64_t* read_start,
                     int64_t r0, int64_t r1, int64_t k,
                     const IndexView& ix, const int64_t* db_offsets,
                     int64_t n_targets, int64_t bin_w, int64_t min_hits,
                     int32_t* out_nc, BinVecs* out) {
    (void)db_offsets;
    (void)n_targets;
    const int64_t mask = ((int64_t)1 << (2 * k)) - 1;
    const int64_t eff_min = min_hits > 1 ? min_hits : 1;
    std::vector<uint8_t> rc;
    std::vector<int64_t> hk;       // bin keys
    std::vector<int32_t> hd;       // diagonals
    std::vector<int64_t> members;
    RadixWs ws;
    for (int64_t r = r0; r < r1; ++r) {
        const int64_t lo = read_start[r], hi = read_start[r + 1];
        const int64_t n = hi - lo;
        int64_t n_cand = 0;
        if (n >= k) {
            rc.resize((size_t)n);
            for (int64_t i = 0; i < n; ++i)
                rc[(size_t)i] = (uint8_t)(3 - bases[hi - 1 - i]);
            for (int strand = 0; strand < 2; ++strand) {
                const uint8_t* seq = strand == 0 ? bases + lo : rc.data();
                hk.clear();
                hd.clear();
                int64_t code = 0;
                for (int64_t i = 0; i < k - 1; ++i)
                    code = ((code << 2) | seq[i]) & mask;
                for (int64_t p = 0; p + k <= n; ++p) {
                    code = ((code << 2) | seq[p + k - 1]) & mask;
                    int64_t c, off;
                    idx_lookup(ix, code, &c, &off);
                    for (int64_t j = 0; j < c; ++j) {
                        const int64_t tid = ix.sorted_tid[off + j];
                        const int32_t diag =
                            ix.sorted_local[off + j] - (int32_t)p;
                        hk.push_back(tid * kMAXB
                                     + (floordiv(diag, bin_w) + kB0));
                        hd.push_back(diag);
                    }
                }
                ws.sort(hk, hd);
                // run-length over keys + pair smoothing + median
                const size_t H = hk.size();
                size_t i = 0;
                while (i < H) {
                    size_t j = i + 1;
                    while (j < H && hk[j] == hk[i]) ++j;
                    int64_t smooth = (int64_t)(j - i);
                    size_t j2 = j;
                    if (j < H && hk[j] == hk[i] + 1) {
                        while (j2 < H && hk[j2] == hk[j]) ++j2;
                        smooth += (int64_t)(j2 - j);
                    } else {
                        j2 = j;
                    }
                    if (smooth >= eff_min) {
                        members.clear();
                        for (size_t m = i; m < j2; ++m)
                            members.push_back((int64_t)hd[m]);
                        out->tid.push_back((int32_t)(hk[i] / kMAXB));
                        out->fwd.push_back(strand == 0 ? 1 : 0);
                        out->diag.push_back(median_trunc(members));
                        out->hits.push_back((int32_t)smooth);
                        ++n_cand;
                    }
                    i = j;
                }
            }
        }
        out_nc[r] = (int32_t)n_cand;
    }
}

}  // namespace

int64_t ags_bin(const uint8_t* bases, const int64_t* read_start,
                int64_t n_reads, int64_t k,
                const uint16_t* dense_cnt, const int32_t* dense_off,
                const int32_t* prefix_off, int64_t prefix_len,
                const int64_t* sorted_codes, const int32_t* sorted_tid,
                const int32_t* sorted_local, int64_t max_occ,
                const int64_t* db_offsets, int64_t n_targets,
                int64_t bin_w, int64_t min_hits, int64_t n_threads,
                int32_t* out_nc,
                int32_t** out_tid, uint8_t** out_fwd, int64_t** out_diag,
                int32_t** out_hits) {
    IndexView ix{dense_cnt, dense_off, prefix_off,
                 2 * (k - prefix_len), sorted_codes, sorted_tid,
                 sorted_local, max_occ};
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_reads) n_threads = n_reads > 0 ? n_reads : 1;
    std::vector<BinVecs> parts((size_t)n_threads);
    if (n_threads == 1) {
        bin_reads_range(bases, read_start, 0, n_reads, k, ix, db_offsets,
                        n_targets, bin_w, min_hits, out_nc, &parts[0]);
    } else {
        std::vector<std::thread> th;
        const int64_t per = (n_reads + n_threads - 1) / n_threads;
        for (int64_t t = 0; t < n_threads; ++t) {
            const int64_t r0 = t * per;
            const int64_t r1 = std::min(n_reads, r0 + per);
            if (r0 >= r1) break;
            th.emplace_back(bin_reads_range, bases, read_start, r0, r1,
                            k, std::cref(ix), db_offsets, n_targets,
                            bin_w, min_hits, out_nc, &parts[(size_t)t]);
        }
        for (auto& t : th) t.join();
    }
    int64_t total = 0;
    for (auto& p : parts) total += (int64_t)p.tid.size();
    const size_t cap = (size_t)std::max<int64_t>(total, 1);
    int32_t* tid = (int32_t*)std::malloc(cap * sizeof(int32_t));
    uint8_t* fwd = (uint8_t*)std::malloc(cap);
    int64_t* diag = (int64_t*)std::malloc(cap * sizeof(int64_t));
    int32_t* hits = (int32_t*)std::malloc(cap * sizeof(int32_t));
    if (!tid || !fwd || !diag || !hits) {
        std::free(tid); std::free(fwd); std::free(diag); std::free(hits);
        return -1;
    }
    int64_t w = 0;
    for (auto& p : parts) {   // thread ranges are contiguous read spans
        const size_t m = p.tid.size();
        if (m) {
            std::memcpy(tid + w, p.tid.data(), m * sizeof(int32_t));
            std::memcpy(fwd + w, p.fwd.data(), m);
            std::memcpy(diag + w, p.diag.data(), m * sizeof(int64_t));
            std::memcpy(hits + w, p.hits.data(), m * sizeof(int32_t));
            w += (int64_t)m;
        }
    }
    *out_tid = tid;
    *out_fwd = fwd;
    *out_diag = diag;
    *out_hits = hits;
    return total;
}

void ags_bin_free(int32_t* tid, uint8_t* fwd, int64_t* diag,
                  int32_t* hits) {
    std::free(tid); std::free(fwd); std::free(diag); std::free(hits);
}

// Stable LSD radix co-sort of (codes, pos) by code — the SeedIndex
// build's np.argsort replacement.  Codes must be < 2^32 (k <= 16).  Stability
// matters: sorted_pos order within equal codes is part of the index's
// observable contract (hit emission order).
int64_t agr_sort_codes(int64_t* codes, int64_t* pos, int64_t n) {
    if (n <= 1) return 0;
    const int BITS = 16;
    const size_t NB = (size_t)1 << BITS;
    std::vector<int64_t> tc, tp;
    try {
        tc.resize((size_t)n);
        tp.resize((size_t)n);
    } catch (...) {
        return -1;
    }
    std::vector<int64_t> cnt(NB);
    int64_t* sc = codes; int64_t* sp = pos;
    int64_t* dc = tc.data(); int64_t* dp = tp.data();
    for (int pass = 0; pass < 2; ++pass) {
        const int shift = pass * BITS;
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int64_t i = 0; i < n; ++i)
            ++cnt[(size_t)((sc[i] >> shift) & (int64_t)(NB - 1))];
        int64_t acc = 0;
        for (size_t b = 0; b < NB; ++b) {
            int64_t c = cnt[b]; cnt[b] = acc; acc += c;
        }
        for (int64_t i = 0; i < n; ++i) {
            const int64_t slot =
                cnt[(size_t)((sc[i] >> shift) & (int64_t)(NB - 1))]++;
            dc[slot] = sc[i];
            dp[slot] = sp[i];
        }
        std::swap(sc, dc);
        std::swap(sp, dp);
    }
    // two passes of 16 bits end back in the caller's arrays
    return 0;
}

// Greedy stride sampling (PABruijnGraph.tcc sampleSequence /
// graph/pagraph.py sample_sequence): walk the sorted eligible positions
// left to right taking gaps of at least `stride`.  Returns the number
// of selected entries written to out.
int64_t ags_stride_sample(const int64_t* eligible, int64_t n,
                          int64_t stride, int64_t* out) {
    int64_t n_sel = 0;
    int64_t i = 0;
    while (i < n) {
        const int64_t p = eligible[i];
        out[n_sel++] = p;
        const int64_t next = p + stride;
        do {
            ++i;
        } while (i < n && eligible[i] < next);
    }
    return n_sel;
}

}  // extern "C"
