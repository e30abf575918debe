// Copy of aligngraph2_tpu/native/ingest.cpp, built with the same flags
// (graph/ingest_native.py).
//
// Native graph-ingest core: the per-read alignment-replay -> position/edge
// append loop of graph/processor.py (_run_pass/_insert_read and the
// _emit_read_to_ctg/_emit_read_to_ref emitters), which re-designs the
// reference's PositionProcessor::process hot path
// (AlignGraph2 PAGraph/src/tools/position/PositionProcessor.cpp:78-151
// driving Aligner::parseToCtg/parseToRef, Aligner.tcc:23-171, and
// PABruijnGraph::addPositionAndEdge, PABruijnGraph.tcc:5-27).
//
// Python remains the specification: the caller (graph/ingest_native.py)
// pre-applies every record-level filter (group membership, ratio, top-K,
// coverage) and hands this core only the surviving alignments as flat
// arrays.  This core replays the diff masks into emitted (query, target)
// coordinate pairs exactly like align/records.py exact_align_pairs, joins
// pass-1 pairs through the per-contig-base AlignReference CSR, maps dual
// coordinates to flat space (coords/mapper.py layout), samples k-mer
// positions with the greedy stride rule, and appends position/edge
// streams.  Reads stripe over a thread pool like the reference's
// MultiThreadTools (MultiThreadTools.tcc:5-21); output order differs from
// the Python path only in stream order, which the graph's sort-based
// merge phases erase (tests assert final-graph equality).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// 32-bit output streams — the graph stores node ids as int32, flat
// coordinates as uint32 (the reference's own uint32 DualPos width,
// KMerAdjNode.hpp:19-23; the caller guards the mapper layout) and edge
// fields as int32.
struct Buf {
  std::vector<int32_t> pos_node;
  std::vector<uint32_t> pos_ctg, pos_ref;
  std::vector<int32_t> edge_from, edge_to, edge_step;
};

struct Args {
  const uint8_t* read_codes;
  const int64_t* read_off;
  int64_t n_reads;
  const int64_t* aln_off;   // per read: [aln_off[r], aln_off[r+1])
  const uint8_t* aln_strand;
  const uint8_t* aln_walk_fwd;
  const int64_t* aln_q0;
  const int64_t* aln_t0;
  const int32_t* aln_tgt;
  const int64_t* col_off;   // per alignment: columns [col_off[a], col_off[a+1])
  const uint8_t* qd;
  const uint8_t* rd;
  int64_t pass2;            // 0: read->ctg (CSR join), 1: read->ref
  // pass-1 contig-side tables
  const int64_t* ctg_len;
  const int64_t* ctg_flat_start;
  const uint8_t* ctg_fwd;       // group orientation per contig
  const int64_t* ar_soff;       // per contig: offset of its (len+1) CSR row
  const int64_t* ar_eoff;       // per contig: offset of its entries
  const int64_t* ar_start;      // concatenated per-base CSR starts (local)
  const int64_t* ar_ridx;       // entries: signed 1-based ref idx (0 sentinel)
  const int64_t* ar_rpos;
  const int64_t* ref_flat_start;  // ref mapper start[] per ref
  int64_t ref_flat_group;         // pass-2: flat start of the group ref
  // graph side
  const int32_t* node_table;    // dense 4^k code -> node id (-1 absent)
  int64_t k;
  int64_t outer_sample;
};

// one (read_pos, ctg_flat, ref_flat) triple, staged per strand bucket
struct Triple {
  int64_t rpos, cflat, rflat;
};

class Worker {
 public:
  explicit Worker(const Args& a) : a_(a) {}

  Buf buf;

  void run(int64_t rid_begin, int64_t stride) {
    std::vector<Triple> tri[2];        // per strand bucket
    std::vector<int64_t> cnt, start, order, kmers, sel;
    std::vector<uint8_t> codes;
    for (int64_t r = rid_begin; r < a_.n_reads; r += stride) {
      const int64_t rlen = a_.read_off[r + 1] - a_.read_off[r];
      tri[0].clear();
      tri[1].clear();
      for (int64_t ai = a_.aln_off[r]; ai < a_.aln_off[r + 1]; ++ai)
        replay(ai, rlen, tri[a_.aln_strand[ai] ? 1 : 0]);
      // dict order in _run_pass buckets: True (forward) first
      for (int s = 1; s >= 0; --s) {
        if (tri[s].empty()) continue;
        insert_read(r, rlen, s == 1, tri[s], cnt, start, order, kmers,
                    sel, codes);
      }
    }
  }

 private:
  const Args& a_;

  // exact_align_pairs + the emitters' range masks + dual->flat mapping
  void replay(int64_t ai, int64_t rlen, std::vector<Triple>& out) {
    const uint8_t* qd = a_.qd + a_.col_off[ai];
    const uint8_t* rd = a_.rd + a_.col_off[ai];
    const int64_t ncol = a_.col_off[ai + 1] - a_.col_off[ai];
    const bool fwd = a_.aln_walk_fwd[ai] != 0;
    int64_t qp = a_.aln_q0[ai];
    int64_t tp = a_.aln_t0[ai];
    if (a_.pass2) {
      const int64_t rbase = a_.ref_flat_group;
      for (int64_t i = 0; i < ncol; ++i) {
        const int64_t c = fwd ? i : ncol - 1 - i;
        const bool qdv = qd[c] != 0, rdv = rd[c] != 0;
        const bool q_adv = (qdv == rdv) || (!qdv && rdv);
        const bool t_adv = (qdv == rdv) || (qdv && !rdv);
        if (q_adv && qp >= 0 && qp < rlen)
          out.push_back({qp, 0, rbase + tp});
        qp += q_adv;
        tp += t_adv;
      }
      return;
    }
    const int32_t cid = a_.aln_tgt[ai];
    const int64_t clen = a_.ctg_len[cid];
    const bool fwd_c = a_.ctg_fwd[cid] != 0;
    const int64_t cbase = a_.ctg_flat_start[cid] + (fwd_c ? 0 : 2 * clen);
    const int64_t* ar_start = a_.ar_start + a_.ar_soff[cid];
    const int64_t* ar_ridx = a_.ar_ridx + a_.ar_eoff[cid];
    const int64_t* ar_rpos = a_.ar_rpos + a_.ar_eoff[cid];
    for (int64_t i = 0; i < ncol; ++i) {
      const int64_t c = fwd ? i : ncol - 1 - i;
      const bool qdv = qd[c] != 0, rdv = rd[c] != 0;
      const bool q_adv = (qdv == rdv) || (!qdv && rdv);
      const bool t_adv = (qdv == rdv) || (qdv && !rdv);
      if (q_adv && qp >= 0 && qp < rlen && tp >= 0 && tp < clen) {
        const int64_t cflat = cbase + tp;
        for (int64_t e = ar_start[tp]; e < ar_start[tp + 1]; ++e) {
          const int64_t ridx = ar_ridx[e];
          const int64_t rflat =
              ridx == 0 ? 0 : a_.ref_flat_start[ridx - 1] + ar_rpos[e];
          out.push_back({qp, cflat, rflat});
        }
      }
      qp += q_adv;
      tp += t_adv;
    }
  }

  // _insert_read: stable sort by read base, per-base CSR, rolling k-mers,
  // dense node lookup, greedy stride sampling, position + edge appends
  void insert_read(int64_t r, int64_t rlen, bool forward,
                   const std::vector<Triple>& tri, std::vector<int64_t>& cnt,
                   std::vector<int64_t>& start, std::vector<int64_t>& order,
                   std::vector<int64_t>& kmers, std::vector<int64_t>& sel,
                   std::vector<uint8_t>& codes) {
    const int64_t k = a_.k;
    if (rlen < k) return;
    // counting sort by read position (stable == np.argsort kind='stable')
    cnt.assign(rlen + 1, 0);
    for (const Triple& t : tri) ++cnt[t.rpos + 1];
    start.assign(rlen + 1, 0);
    for (int64_t i = 0; i < rlen; ++i) start[i + 1] = start[i] + cnt[i + 1];
    order.resize(tri.size());
    {
      std::vector<int64_t> cur(start.begin(), start.end() - 1);
      for (size_t i = 0; i < tri.size(); ++i)
        order[cur[tri[i].rpos]++] = static_cast<int64_t>(i);
    }
    // strand codes + rolling k-mer codes -> node ids
    const uint8_t* fwd_codes = a_.read_codes + a_.read_off[r];
    codes.resize(rlen);
    if (forward) {
      std::memcpy(codes.data(), fwd_codes, rlen);
    } else {
      for (int64_t i = 0; i < rlen; ++i)
        codes[i] = 3 - fwd_codes[rlen - 1 - i];
    }
    const int64_t n_kmer = rlen - k + 1;
    const int64_t mask = (int64_t(1) << (2 * k)) - 1;
    kmers.resize(n_kmer);
    int64_t code = 0;
    for (int64_t i = 0; i < k - 1; ++i) code = (code << 2) | codes[i];
    for (int64_t i = 0; i < n_kmer; ++i) {
      code = ((code << 2) | codes[i + k - 1]) & mask;
      kmers[i] = code;
    }
    // greedy stride sampling over eligible (solid node AND has positions)
    sel.clear();
    int64_t next_ok = 0;
    for (int64_t p = 0; p < n_kmer; ++p) {
      if (p < next_ok) continue;
      if (start[p + 1] == start[p]) continue;
      if (a_.node_table[kmers[p]] < 0) continue;
      sel.push_back(p);
      next_ok = p + a_.outer_sample;
    }
    if (sel.empty()) return;
    int64_t prev_node = -1;
    int64_t prev_p = -1;
    for (int64_t p : sel) {
      const int64_t node = a_.node_table[kmers[p]];
      for (int64_t j = start[p]; j < start[p + 1]; ++j) {
        const Triple& t = tri[order[j]];
        buf.pos_node.push_back(static_cast<int32_t>(node));
        buf.pos_ctg.push_back(static_cast<uint32_t>(t.cflat));
        buf.pos_ref.push_back(static_cast<uint32_t>(t.rflat));
      }
      if (prev_node >= 0) {
        buf.edge_from.push_back(static_cast<int32_t>(prev_node));
        buf.edge_to.push_back(static_cast<int32_t>(node));
        buf.edge_step.push_back(static_cast<int32_t>(p - prev_p));
      }
      prev_node = node;
      prev_p = p;
    }
  }
};

template <typename T>
T* to_heap(const std::vector<Buf>& bufs, std::vector<T> Buf::*member,
           int64_t total) {
  T* out = static_cast<T*>(std::malloc(sizeof(T) * (total ? total : 1)));
  if (!out) return nullptr;
  int64_t at = 0;
  for (const Buf& b : bufs) {
    const std::vector<T>& v = b.*member;
    std::memcpy(out + at, v.data(), v.size() * sizeof(T));
    at += static_cast<int64_t>(v.size());
  }
  return out;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 on allocation failure.  Outputs are malloc'd
// int32/uint32 arrays (free with agp_free); *n_pos / *n_edge give their
// lengths.
int64_t agp_ingest_pass(
    const uint8_t* read_codes, const int64_t* read_off, int64_t n_reads,
    const int64_t* aln_off, const uint8_t* aln_strand,
    const uint8_t* aln_walk_fwd, const int64_t* aln_q0, const int64_t* aln_t0,
    const int32_t* aln_tgt, const int64_t* col_off, const uint8_t* qd,
    const uint8_t* rd, int64_t pass2, const int64_t* ctg_len,
    const int64_t* ctg_flat_start, const uint8_t* ctg_fwd,
    const int64_t* ar_soff, const int64_t* ar_eoff, const int64_t* ar_start,
    const int64_t* ar_ridx, const int64_t* ar_rpos,
    const int64_t* ref_flat_start, int64_t ref_flat_group,
    const int32_t* node_table, int64_t k, int64_t outer_sample,
    int64_t n_threads, int32_t** pos_node, uint32_t** pos_ctg,
    uint32_t** pos_ref, int32_t** edge_from, int32_t** edge_to,
    int32_t** edge_step, int64_t* n_pos, int64_t* n_edge) {
  Args a;
  a.read_codes = read_codes;
  a.read_off = read_off;
  a.n_reads = n_reads;
  a.aln_off = aln_off;
  a.aln_strand = aln_strand;
  a.aln_walk_fwd = aln_walk_fwd;
  a.aln_q0 = aln_q0;
  a.aln_t0 = aln_t0;
  a.aln_tgt = aln_tgt;
  a.col_off = col_off;
  a.qd = qd;
  a.rd = rd;
  a.pass2 = pass2;
  a.ctg_len = ctg_len;
  a.ctg_flat_start = ctg_flat_start;
  a.ctg_fwd = ctg_fwd;
  a.ar_soff = ar_soff;
  a.ar_eoff = ar_eoff;
  a.ar_start = ar_start;
  a.ar_ridx = ar_ridx;
  a.ar_rpos = ar_rpos;
  a.ref_flat_start = ref_flat_start;
  a.ref_flat_group = ref_flat_group;
  a.node_table = node_table;
  a.k = k;
  a.outer_sample = outer_sample < 1 ? 1 : outer_sample;

  int64_t T = n_threads < 1 ? 1 : n_threads;
  if (T > n_reads && n_reads > 0) T = n_reads;
  if (T < 1) T = 1;
  std::vector<Worker> workers;
  workers.reserve(T);
  for (int64_t t = 0; t < T; ++t) workers.emplace_back(a);
  if (T == 1) {
    workers[0].run(0, 1);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(T);
    for (int64_t t = 0; t < T; ++t)
      pool.emplace_back([&workers, t, T] { workers[t].run(t, T); });
    for (std::thread& th : pool) th.join();
  }

  std::vector<Buf> bufs;
  bufs.reserve(T);
  for (Worker& w : workers) bufs.push_back(std::move(w.buf));
  int64_t np = 0, ne = 0;
  for (const Buf& b : bufs) {
    np += static_cast<int64_t>(b.pos_node.size());
    ne += static_cast<int64_t>(b.edge_from.size());
  }
  *pos_node = to_heap(bufs, &Buf::pos_node, np);
  *pos_ctg = to_heap(bufs, &Buf::pos_ctg, np);
  *pos_ref = to_heap(bufs, &Buf::pos_ref, np);
  *edge_from = to_heap(bufs, &Buf::edge_from, ne);
  *edge_to = to_heap(bufs, &Buf::edge_to, ne);
  *edge_step = to_heap(bufs, &Buf::edge_step, ne);
  *n_pos = np;
  *n_edge = ne;
  if (!*pos_node || !*pos_ctg || !*pos_ref || !*edge_from || !*edge_to ||
      !*edge_step)
    return -1;
  return 0;
}

void agp_free(void* p) { std::free(p); }

// Radix-based epsilon position merge (PABruijnGraph::mergeKmerPosition
// semantics as specified by graph/pagraph.py merge_positions): 16-byte
// records LSD-radix-sorted by (node, ctg, ref) with 16-bit counting
// passes (64 Ki-bin histograms stay L2-resident; constant digits are
// skipped), then one linear chain-cluster pass — a new cluster opens
// where a position is not similar to its predecessor (per-axis: both
// nonzero and within epsilon, or both zero); the representative is the
// cluster's first (minimum) member and counts sum with the uint16
// CountType cap.  Identical output to the numpy spec.  Inputs/outputs
// are the graph's storage dtypes (int32 node, uint32 coords, uint16
// counts).  Returns 0, or -1 on allocation failure.
int64_t agp_merge_pos2(const int32_t* node, const uint32_t* ctg,
                       const uint32_t* ref, const uint16_t* cnt, int64_t n,
                       int64_t n_nodes, int64_t eps, int64_t n_threads,
                       int32_t** out_node, uint32_t** out_ctg,
                       uint32_t** out_ref, uint16_t** out_cnt,
                       int64_t* out_n) {
  (void)n_threads;
  (void)n_nodes;
  if (n <= 0) {
    *out_node = nullptr;
    *out_ctg = *out_ref = nullptr;
    *out_cnt = nullptr;
    *out_n = 0;
    return 0;
  }
  struct Rec {
    uint32_t node, ctg, ref, cnt;
  };
  Rec* a = static_cast<Rec*>(std::malloc(sizeof(Rec) * n));
  Rec* b = static_cast<Rec*>(std::malloc(sizeof(Rec) * n));
  if (!a || !b) {
    std::free(a);
    std::free(b);
    return -1;
  }
  for (int64_t i = 0; i < n; ++i)
    a[i] = {static_cast<uint32_t>(node[i]), ctg[i], ref[i], cnt[i]};
  // LSD passes, least significant first: ref lo/hi, ctg lo/hi, node
  // lo/hi — yields (node, ctg, ref) lexicographic order, stable
  static thread_local std::vector<int64_t> hist;
  hist.assign(1 << 16, 0);
  auto digit_of = [](const Rec& r, int pass) -> uint32_t {
    switch (pass) {
      case 0: return r.ref & 0xFFFF;
      case 1: return r.ref >> 16;
      case 2: return r.ctg & 0xFFFF;
      case 3: return r.ctg >> 16;
      case 4: return r.node & 0xFFFF;
      default: return r.node >> 16;
    }
  };
  Rec* src = a;
  Rec* dst = b;
  for (int pass = 0; pass < 6; ++pass) {
    std::fill(hist.begin(), hist.end(), 0);
    for (int64_t i = 0; i < n; ++i) ++hist[digit_of(src[i], pass)];
    // constant digit: nothing moves
    if (hist[digit_of(src[0], pass)] == n) continue;
    int64_t run = 0;
    for (int64_t d = 0; d < (1 << 16); ++d) {
      const int64_t c = hist[d];
      hist[d] = run;
      run += c;
    }
    for (int64_t i = 0; i < n; ++i) dst[hist[digit_of(src[i], pass)]++] = src[i];
    std::swap(src, dst);
  }
  // linear chain-cluster (same predecessor rule as agp_merge_pos)
  int64_t w = 0;
  Rec prev = src[0];
  for (int64_t i = 1; i < n; ++i) {
    const Rec cur = src[i];
    const bool s1 =
        prev.ctg != 0 && cur.ctg != 0 &&
        (prev.ctg > cur.ctg ? prev.ctg - cur.ctg : cur.ctg - prev.ctg) <=
            static_cast<uint32_t>(eps);
    const bool s2 =
        prev.ref != 0 && cur.ref != 0 &&
        (prev.ref > cur.ref ? prev.ref - cur.ref : cur.ref - prev.ref) <=
            static_cast<uint32_t>(eps);
    const bool sim1 = s1 || (prev.ctg == 0 && cur.ctg == 0);
    const bool sim2 = s2 || (prev.ref == 0 && cur.ref == 0);
    if (sim1 && sim2 && src[w].node == cur.node) {
      const uint64_t s = (uint64_t)src[w].cnt + cur.cnt;
      src[w].cnt = s > 0xFFFF ? 0xFFFF : (uint32_t)s;
    } else {
      src[++w] = cur;
    }
    prev = cur;
  }
  const int64_t total = w + 1;
  int32_t* on = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * total));
  uint32_t* oc =
      static_cast<uint32_t*>(std::malloc(sizeof(uint32_t) * total));
  uint32_t* orf =
      static_cast<uint32_t*>(std::malloc(sizeof(uint32_t) * total));
  uint16_t* ocnt =
      static_cast<uint16_t*>(std::malloc(sizeof(uint16_t) * total));
  if (!on || !oc || !orf || !ocnt) {
    std::free(a);
    std::free(b);
    std::free(on);
    std::free(oc);
    std::free(orf);
    std::free(ocnt);
    return -1;
  }
  for (int64_t i = 0; i < total; ++i) {
    on[i] = static_cast<int32_t>(src[i].node);
    oc[i] = src[i].ctg;
    orf[i] = src[i].ref;
    ocnt[i] = static_cast<uint16_t>(src[i].cnt);
  }
  std::free(a);
  std::free(b);
  *out_node = on;
  *out_ctg = oc;
  *out_ref = orf;
  *out_cnt = ocnt;
  *out_n = total;
  return 0;
}

// Fused radix edge dedup: exact (from, to, step) unique in (from, to,
// step)-ascending order — the same counting-pass pattern as
// agp_merge_pos2, one linear compaction at the end.  Fields are the
// graph's int32 storage (non-negative by construction).
int64_t agp_merge_edges(const int32_t* frm, const int32_t* to,
                        const int32_t* step, int64_t n,
                        int32_t** out_from, int32_t** out_to,
                        int32_t** out_step, int64_t* out_n) {
  if (n <= 0) {
    *out_from = *out_to = *out_step = nullptr;
    *out_n = 0;
    return 0;
  }
  struct Rec {
    uint32_t f, t, s;
  };
  Rec* a = static_cast<Rec*>(std::malloc(sizeof(Rec) * n));
  Rec* b = static_cast<Rec*>(std::malloc(sizeof(Rec) * n));
  if (!a || !b) {
    std::free(a);
    std::free(b);
    return -1;
  }
  for (int64_t i = 0; i < n; ++i)
    a[i] = {static_cast<uint32_t>(frm[i]), static_cast<uint32_t>(to[i]),
            static_cast<uint32_t>(step[i])};
  static thread_local std::vector<int64_t> hist;
  hist.assign(1 << 16, 0);
  auto digit_of = [](const Rec& r, int pass) -> uint32_t {
    switch (pass) {
      case 0: return r.s & 0xFFFF;
      case 1: return r.s >> 16;
      case 2: return r.t & 0xFFFF;
      case 3: return r.t >> 16;
      case 4: return r.f & 0xFFFF;
      default: return r.f >> 16;
    }
  };
  Rec* src = a;
  Rec* dst = b;
  for (int pass = 0; pass < 6; ++pass) {
    std::fill(hist.begin(), hist.end(), 0);
    for (int64_t i = 0; i < n; ++i) ++hist[digit_of(src[i], pass)];
    if (hist[digit_of(src[0], pass)] == n) continue;
    int64_t run = 0;
    for (int64_t d = 0; d < (1 << 16); ++d) {
      const int64_t c = hist[d];
      hist[d] = run;
      run += c;
    }
    for (int64_t i = 0; i < n; ++i)
      dst[hist[digit_of(src[i], pass)]++] = src[i];
    std::swap(src, dst);
  }
  int64_t w = 0;
  for (int64_t i = 1; i < n; ++i) {
    const Rec cur = src[i];
    if (cur.f != src[w].f || cur.t != src[w].t || cur.s != src[w].s)
      src[++w] = cur;
  }
  const int64_t total = w + 1;
  int32_t* of = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * total));
  int32_t* ot = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * total));
  int32_t* os = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * total));
  if (!of || !ot || !os) {
    std::free(a);
    std::free(b);
    std::free(of);
    std::free(ot);
    std::free(os);
    return -1;
  }
  for (int64_t i = 0; i < total; ++i) {
    of[i] = static_cast<int32_t>(src[i].f);
    ot[i] = static_cast<int32_t>(src[i].t);
    os[i] = static_cast<int32_t>(src[i].s);
  }
  std::free(a);
  std::free(b);
  *out_from = of;
  *out_to = ot;
  *out_step = os;
  *out_n = total;
  return 0;
}

// Stable LSD radix argsort over three int64 keys, equivalent to
// np.lexsort((k3, k2, k1)) — primary k1, secondary k2, tertiary k3 —
// which is the graph's position ordering (node, ctg, ref).  16-bit
// digits, only as many passes per key as its maximum needs; ~6 passes
// at genome scale vs numpy's three full mergesorts (measured 179 s ->
// seconds on a 50M-position merge).  Returns 0, or -1 on alloc failure.
int64_t agp_sort3(const int64_t* k1, const int64_t* k2, const int64_t* k3,
                  int64_t n, int64_t* perm) {
  if (n <= 0) return 0;
  int64_t* tmp =
      static_cast<int64_t*>(std::malloc(sizeof(int64_t) * n));
  if (!tmp) return -1;
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  int64_t* src = perm;
  int64_t* dst = tmp;
  std::vector<int64_t> count(1 << 16);
  const int64_t* keys[3] = {k3, k2, k1};  // least-significant key first
  for (const int64_t* key : keys) {
    int64_t mx = 0, mn = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (key[i] > mx) mx = key[i];
      if (key[i] < mn) mn = key[i];
    }
    if (mn < 0) {  // radix digits assume non-negative keys
      std::free(tmp);
      return -2;
    }
    if (mx == 0) continue;  // constant key: stable order already holds
    for (int shift = 0; (mx >> shift) != 0 || shift == 0; shift += 16) {
      std::fill(count.begin(), count.end(), 0);
      for (int64_t i = 0; i < n; ++i)
        ++count[(key[src[i]] >> shift) & 0xFFFF];
      int64_t at = 0;
      for (int64_t b = 0; b < (1 << 16); ++b) {
        const int64_t c = count[b];
        count[b] = at;
        at += c;
      }
      for (int64_t i = 0; i < n; ++i)
        dst[count[(key[src[i]] >> shift) & 0xFFFF]++] = src[i];
      std::swap(src, dst);
      if ((mx >> (shift + 16)) == 0) break;
    }
  }
  if (src != perm) std::memcpy(perm, src, sizeof(int64_t) * n);
  std::free(tmp);
  return 0;
}

}  // extern "C"
