// Copy of aligngraph2_tpu/native/traverse.cpp, built with the same flags
// (traverse/native.py).
//
// Native traversal core for the pagraph stage.
//
// Implements PAlgorithm::travelSequence and its whole call tree
// (AlignGraph2 PAGraph/src/tools/graph/PAlgorithm.{cpp,tcc}:
// classifySuccessors, walkStraight, graphTravel, searchPANode(2),
// appendSeq, filterSequence, editDistance) over the SoA graph arrays
// built by aligngraph2_tpu/graph/pagraph.py (position/edge CSR tables
// shared zero-copy via ctypes).
//
// The semantics mirror aligngraph2_tpu/traverse/walk.py EXACTLY —
// candidate ordering, grade-class selection, tie-breaking, the uint32
// wraparound ratio arithmetic, stable re-seed sorting — so the Python
// module remains the readable specification and the parity oracle
// (tests/test_native_traverse.py).  Traversal is irregular
// pointer-chasing over host-resident tables: the one part of the
// pipeline that belongs on the host CPU, exactly as in the reference.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

using std::int64_t;
using std::uint64_t;
using std::uint8_t;

constexpr uint64_t MASK32 = 0xFFFFFFFFull;
enum Status { END = 0, BRANCH = 1, LIMIT = 2, LEAP = 3 };
enum Grade { Oops = 0, Skip = 1, Good = 2, Excellent = 3, Amazing = 4 };

struct Mapper {
    int64_t n = 0;
    const int64_t* lengths = nullptr;
    const int64_t* start = nullptr;  // n+1

    // dual_to_single: signed 1-based idx + pos -> flat (0 -> 0)
    int64_t d2s(int64_t sidx, int64_t pos) const {
        if (sidx == 0) return 0;
        int64_t idx = std::llabs(sidx) - 1;
        int64_t offset = sidx > 0 ? 0 : 2 * lengths[idx];
        return start[idx] + offset + pos;
    }

    // single_to_dual: flat -> (signed idx, pos); 0 -> (0, 0)
    void s2d(int64_t flat, int64_t* out_idx, int64_t* out_pos) const {
        if (flat == 0) { *out_idx = 0; *out_pos = 0; return; }
        // upper_bound over start[0..n], step back one unless at begin
        const int64_t* ub = std::upper_bound(start, start + n + 1, flat);
        int64_t it = (int64_t)(ub - start) - 1;
        if (it < 0) it = 0;
        int64_t idx = it;
        int64_t offset = flat - start[idx];
        int64_t li = idx < n ? idx : n - 1;
        int64_t size2 = n > 0 ? 2 * lengths[li] : 0;
        bool rev = offset >= size2;
        *out_idx = rev ? -(idx + 1) : idx + 1;
        *out_pos = rev ? offset - size2 : offset;
    }

    int64_t seq_size(int64_t sidx) const {
        if (sidx == 0) return 0;
        return lengths[std::llabs(sidx) - 1];
    }
};

// ---- grading (graph/pagraph.py:is_pos_similar/is_edge_similar/
//      check_position — the reference's uint32 wraparound semantics) ----

inline void pos_similar(uint64_t lc, uint64_t lr, uint64_t rc, uint64_t rr,
                        int64_t dev, bool* s1, bool* s2) {
    int64_t dc = std::llabs((int64_t)lc - (int64_t)rc);
    int64_t dr = std::llabs((int64_t)lr - (int64_t)rr);
    *s1 = lc != 0 && rc != 0 && dc <= dev;
    *s2 = lr != 0 && rr != 0 && dr <= dev;
}

inline void edge_similar(uint64_t lc, uint64_t lr, uint64_t rc, uint64_t rr,
                         int64_t dist, int64_t dev, double er,
                         bool* s1, bool* s2) {
    uint64_t tc = lc != 0 ? ((lc + (uint64_t)dist) & MASK32) : 0;
    uint64_t tr = lr != 0 ? ((lr + (uint64_t)dist) & MASK32) : 0;
    pos_similar(tc, tr, rc, rr, dev, s1, s2);
    double rat_c = std::fabs(1.0 - (double)((rc - lc) & MASK32) / dist);
    double rat_r = std::fabs(1.0 - (double)((rr - lr) & MASK32) / dist);
    *s1 = *s1 || (lc != 0 && rc != 0 && rat_c <= er);
    *s2 = *s2 || (lr != 0 && rr != 0 && rat_r <= er);
}

// Integerized ratio test.  The spec's ``fabs(1 - delta/dist) <= er``
// is monotone in the integer delta on either side of dist, so for each
// (er, dist) there are exact integer thresholds up/dn with
//   spec(delta)  <=>  delta >= dist ? delta-dist <= up : dist-delta <= dn.
// The thresholds are found with the EXACT spec formula at the boundary
// (make_thr below), making the hot loop division-free while staying
// bit-identical to the double formulation of walk.py / pagraph.py.
struct Thr {
    int64_t up, dn;
};

inline bool ratio_exact(uint64_t delta, int64_t dist, double er) {
    return std::fabs(1.0 - (double)delta / (double)dist) <= er;
}

inline Thr make_thr(int64_t dist, double er) {
    if (dist <= 0) return {-1, -1};  // spec: inf/nan ratios never pass
    int64_t g = (int64_t)(er * (double)dist) + 2;
    while (g > 0 && !ratio_exact((uint64_t)(dist + g), dist, er)) --g;
    int64_t up = ratio_exact((uint64_t)(dist + g), dist, er) ? g : -1;
    g = std::min((int64_t)(er * (double)dist) + 2, dist);
    while (g > 0 && !ratio_exact((uint64_t)(dist - g), dist, er)) --g;
    int64_t dn = ratio_exact((uint64_t)(dist - g), dist, er) ? g : -1;
    return {up, dn};
}

inline bool ratio_ok(uint64_t delta, int64_t dist, const Thr& t) {
    int64_t d = (int64_t)delta;  // wrapped uint32 value, fits int64
    return d >= dist ? (d - dist) <= t.up : (dist - d) <= t.dn;
}

// check_position fused with the guarded edge_similar outputs the level
// filters need (es1/es2) — the pre-fused code graded each candidate
// with 6 double divisions across two passes.
inline int check_position_fast(uint64_t p1c, uint64_t p1r, uint64_t p2c,
                               uint64_t p2r, int64_t dist, int64_t dev,
                               const Thr& thr, bool* es1, bool* es2) {
    uint64_t dc = (p2c - p1c) & MASK32;
    uint64_t dr = (p2r - p1r) & MASK32;
    bool rc_ok = ratio_ok(dc, dist, thr);
    bool rr_ok = ratio_ok(dr, dist, thr);
    uint64_t tc = p1c != 0 ? ((p1c + (uint64_t)dist) & MASK32) : 0;
    uint64_t tr = p1r != 0 ? ((p1r + (uint64_t)dist) & MASK32) : 0;
    bool band1 = tc != 0 && p2c != 0
        && std::llabs((int64_t)tc - (int64_t)p2c) <= dev;
    bool band2 = tr != 0 && p2r != 0
        && std::llabs((int64_t)tr - (int64_t)p2r) <= dev;
    bool e1 = band1 || (p1c != 0 && p2c != 0 && rc_ok);
    bool e2 = band2 || (p1r != 0 && p2r != 0 && rr_ok);
    *es1 = e1;
    *es2 = e2;
    bool s1 = e1 || rc_ok;
    bool s2 = e2 || rr_ok;
    bool ctg_zero = p1c == 0 || p2c == 0;
    bool ref_zero = p1r == 0 || p2r == 0;
    if (ctg_zero) {
        if (!s2) return Oops;
        if (p2c != 0) return Excellent;
        if (p1c != 0) return Skip;
        return Good;
    }
    if (ref_zero) {
        if (!s1) return Oops;
        return p2r != 0 ? Excellent : Good;
    }
    if (s1 && s2) return Amazing;
    if (s1) return Excellent;
    if (s2) return Skip;
    return Oops;
}

// ---- traversal state ----

struct Step {
    int64_t node, pos, dist;
};

struct PosTable {
    int64_t lo = 4294967295LL;  // uint32 max (walk.py _PosTable)
    int64_t hi = 0;
    void reset() { lo = 4294967295LL; hi = 0; }
    void insert(int64_t p) {
        if (p == 0) return;
        lo = std::min(lo, p);
        hi = std::max(hi, p);
    }
};

struct Level {
    // uint8 epoch stamps: 1 byte per graph position entry.  Workspaces
    // replicate one stamp array per level per walk thread (~17 arrays
    // per concurrent travel), so byte stamps keep the whole workspace
    // cache- and RSS-friendly (50 MB vs 200 MB per level at the 5 Mb
    // bench's 49M positions).  The 255-epoch wrap costs one 50 MB clear
    // every 255 walks — microseconds amortized.
    std::vector<uint8_t> stamp;
    uint8_t epoch = 0;
    PosTable table;
    void init(int64_t n_pos) {
        if ((int64_t)stamp.size() != n_pos) stamp.assign((size_t)n_pos, 0);
    }
    void new_epoch() {
        if (epoch == 0xFF) {
            std::fill(stamp.begin(), stamp.end(), 0);
            epoch = 0;
        }
        ++epoch;
        table.reset();
    }
    void add(int64_t pi) { stamp[(size_t)pi] = epoch; }
    bool member(int64_t pi) const { return stamp[(size_t)pi] == epoch; }
};

struct Cand {
    int64_t node, pos, step;
    int grade;
};

// Per-concurrent-travel mutable state.  ``tls``/``wls`` hold one
// travel/walk level pair per walk thread (the reference's <= top_k
// parallel seed walks, PAlgorithm.cpp:230, each with disjoint levels).
struct Workspace {
    Level gl;
    std::vector<Level> tls, wls;
};

struct Handle {
    // graph SoA (borrowed pointers; numpy arrays kept alive by Python).
    // Streams use the graph's narrow storage dtypes (uint32 coords,
    // uint16 counts, int32 edges — pagraph.py POS_DTYPES/EDGE_DTYPES);
    // all arithmetic widens to 64-bit on load.
    int64_t n_nodes = 0, n_pos = 0, k = 0;
    const int64_t* node_codes = nullptr;
    const int64_t* pos_start = nullptr;
    const uint32_t* pos_ctg = nullptr;
    const uint32_t* pos_ref = nullptr;
    const uint16_t* pos_count = nullptr;
    const uint8_t* used = nullptr;
    const int64_t* edge_start = nullptr;
    const int32_t* edge_to = nullptr;
    const int32_t* edge_step = nullptr;
    Mapper ctg_map, ref_map;
    // params
    int64_t deviation = 0, min_len = 0, top_k = 8;
    double error_rate = 0.0, start_split = 0.0;
    int walk_threads = 1;
    // ratio thresholds per edge-step value (index = dist)
    std::vector<Thr> thr_table;

    void build_thr_table(int64_t n_edges) {
        int64_t max_step = 0;
        for (int64_t e = 0; e < n_edges; ++e)
            max_step = std::max(max_step, (int64_t)edge_step[e]);
        thr_table.resize((size_t)max_step + 1);
        for (int64_t d = 0; d <= max_step; ++d)
            thr_table[(size_t)d] = make_thr(d, error_rate);
    }
    // workspace pool: agt_travel is re-entrant (the per-contig travel
    // loop runs threadNum/8-wide in Python, PAssembly.cpp:30 semantics)
    std::mutex ws_mu;
    std::vector<std::unique_ptr<Workspace>> ws_pool;

    Workspace* acquire() {
        std::lock_guard<std::mutex> g(ws_mu);
        if (!ws_pool.empty()) {
            Workspace* w = ws_pool.back().release();
            ws_pool.pop_back();
            return w;
        }
        Workspace* w = new Workspace();
        w->gl.init(n_pos);
        w->tls.resize((size_t)std::max(walk_threads, 1));
        w->wls.resize((size_t)std::max(walk_threads, 1));
        return w;
    }
    void release(Workspace* w) {
        std::lock_guard<std::mutex> g(ws_mu);
        ws_pool.emplace_back(w);
    }
};

// classify_successors (walk.py:113-175) fused with graph.successors
// (pagraph.py:307-344); levels given explicitly, rev filter only for the
// global level (index 0 of the Python levels list).
void classify_successors(Handle* h, int64_t node, int64_t pos_idx,
                         int64_t ctg_left, int64_t ctg_right, bool can_leap,
                         double leap_min, const Level* const* levels,
                         int n_levels, const int64_t* rev_range,
                         std::vector<Cand>& out) {
    out.clear();
    uint64_t p1c = h->pos_ctg[pos_idx];
    uint64_t p1r = h->pos_ref[pos_idx];
    for (int64_t e = h->edge_start[node]; e < h->edge_start[node + 1]; ++e) {
        int64_t child = h->edge_to[e];
        int64_t step = h->edge_step[e];
        const Thr thr = h->thr_table[(size_t)step];
        for (int64_t pi = h->pos_start[child];
             pi < h->pos_start[child + 1]; ++pi) {
            if (h->used[pi]) continue;
            bool es1, es2;
            int g = check_position_fast(p1c, p1r, h->pos_ctg[pi],
                                        h->pos_ref[pi], step, h->deviation,
                                        thr, &es1, &es2);
            if (g == Oops) continue;
            // level filters (walk.py:129-136)
            int64_t pc = (int64_t)h->pos_ctg[pi];
            bool spc0 = pc == 0;
            bool keep = true;
            for (int li = 0; li < n_levels && keep; ++li) {
                const Level* lvl = levels[li];
                bool in_table = lvl->table.lo <= pc && pc <= lvl->table.hi;
                if (lvl->member(pi)) { keep = false; break; }
                if (!(spc0 || es1 || !in_table)) { keep = false; break; }
                if (li == 0 && rev_range != nullptr) {
                    bool in_rev = pc >= rev_range[0] && pc < rev_range[1];
                    if (!(spc0 || !in_rev)) { keep = false; break; }
                }
            }
            if (!keep) continue;
            out.push_back({child, pi, step, g});
        }
    }
    if (out.empty()) return;
    // leap gate + grade-class selection (walk.py:143-175)
    size_t n = out.size();
    std::vector<uint8_t> leap(n), ok(n, 1);
    for (size_t i = 0; i < n; ++i) {
        int64_t pc = (int64_t)h->pos_ctg[out[i].pos];
        leap[i] = pc != 0 && (pc < ctg_left || pc >= ctg_right);
        if (leap[i]) {
            if (!can_leap) { ok[i] = 0; continue; }
            int64_t lidx, lpos;
            h->ctg_map.s2d(pc, &lidx, &lpos);
            int64_t size = h->ctg_map.seq_size(lidx);
            if ((double)lpos > (double)size * leap_min) ok[i] = 0;
        }
    }
    auto select = [&](int want_grade, bool include_leap,
                      bool exclude_leap) {
        std::vector<Cand> sel;
        for (size_t i = 0; i < n; ++i) {
            if (!ok[i]) continue;
            bool hit = include_leap
                ? (out[i].grade == want_grade || leap[i])
                : (out[i].grade == want_grade
                   && (!exclude_leap || !leap[i]));
            if (hit) sel.push_back(out[i]);
        }
        return sel;
    };
    std::vector<Cand> sel = select(Amazing, true, false);
    if (sel.empty()) sel = select(Excellent, false, true);
    if (sel.empty()) sel = select(Good, false, true);
    if (sel.empty() && can_leap) sel = select(Skip, false, true);
    out.swap(sel);
}

int walk_straight(Handle* h, Level* gl, Level* tl, Level* wl, Step start,
                  std::vector<Step>& path,
                  int64_t ctg_left, int64_t ctg_right, int64_t has_size,
                  int64_t split_size, double split_min,
                  const int64_t* rev_range) {
    wl->new_epoch();
    const Level* levels[3] = {gl, tl, wl};
    int64_t now_size = start.dist;
    path.push_back(start);
    int64_t pc = (int64_t)h->pos_ctg[start.pos];
    if (pc != 0 && (pc < ctg_left || pc >= ctg_right)) return LEAP;
    wl->table.insert(pc);
    wl->add(start.pos);
    std::vector<Cand> succ;
    for (;;) {
        classify_successors(h, path.back().node, path.back().pos,
                            ctg_left, ctg_right,
                            has_size + now_size >= split_size, split_min,
                            levels, 3, rev_range, succ);
        if (succ.empty()) return END;
        if (succ.size() > 1) return BRANCH;
        const Cand& c = succ[0];
        wl->add(c.pos);
        int64_t spc = (int64_t)h->pos_ctg[c.pos];
        wl->table.insert(spc);
        path.push_back({c.node, c.pos, c.step});
        now_size += c.step;
        if (spc != 0 && (spc < ctg_left || spc >= ctg_right)) return LEAP;
    }
}

void graph_travel(Handle* h, Level* gl, Level* tl, Level* wl,
                  int64_t start_node, int64_t start_pos,
                  int64_t ctg_left, int64_t ctg_right, int64_t has_size,
                  int64_t split_size, double split_min,
                  const int64_t* rev_range, std::vector<Step>& seq) {
    seq.clear();
    tl->new_epoch();
    const Level* levels[2] = {gl, tl};
    int64_t now_size = h->k;
    Step chosen{start_node, start_pos, h->k};
    tl->table.insert((int64_t)h->pos_ctg[start_pos]);

    std::vector<std::vector<Step>> paths(1);
    walk_straight(h, gl, tl, wl, chosen, paths[0], ctg_left, ctg_right,
                  has_size + now_size, split_size, split_min, rev_range);
    size_t chosen_idx = 0;
    std::vector<Cand> succ;
    for (;;) {
        std::vector<Step>& chosen_path = paths[chosen_idx];
        for (const Step& p : chosen_path) {
            seq.push_back(p);
            tl->add(p.pos);
            now_size += p.dist;
            tl->table.insert((int64_t)h->pos_ctg[p.pos]);
        }
        const Step& last = seq.back();
        int64_t lpc = (int64_t)h->pos_ctg[last.pos];
        if (lpc != 0 && (lpc < ctg_left || lpc >= ctg_right)) break;
        classify_successors(h, last.node, last.pos, ctg_left, ctg_right,
                            has_size + now_size >= split_size, split_min,
                            levels, 2, rev_range, succ);
        // walk every successor path; choose leap > max-abundance branch >
        // longest tip (walk.py:271-302)
        std::vector<std::pair<size_t, size_t>> leap_l, branch_l, tips_l;
        std::vector<std::vector<Step>> new_paths(succ.size());
        for (size_t i = 0; i < succ.size(); ++i) {
            Step s{succ[i].node, succ[i].pos, succ[i].step};
            int status = walk_straight(h, gl, tl, wl, s, new_paths[i],
                                       ctg_left, ctg_right,
                                       has_size + now_size,
                                       split_size, split_min, rev_range);
            if (status == LEAP) leap_l.push_back({i, new_paths[i].size()});
            else if (status == END) tips_l.push_back({i, new_paths[i].size()});
            else branch_l.push_back({i, new_paths[i].size()});
        }
        paths.swap(new_paths);
        if (leap_l.empty() && tips_l.empty() && branch_l.empty()) break;
        if (!leap_l.empty()) {
            chosen_idx = leap_l[0].first;
        } else if (!branch_l.empty()) {
            size_t best = 0;
            for (size_t i = 1; i < branch_l.size(); ++i) {
                int64_t a1 = h->pos_count[succ[branch_l[i].first].pos];
                int64_t a2 = h->pos_count[succ[branch_l[best].first].pos];
                if (a1 > a2) best = i;
            }
            chosen_idx = branch_l[best].first;
        } else {
            size_t best = 0;
            for (size_t i = 1; i < tips_l.size(); ++i)
                if (tips_l[i].second > tips_l[best].second) best = i;
            chosen_idx = tips_l[best].first;
        }
    }
}

int64_t edit_distance_codes(const uint8_t* a, int64_t na, const uint8_t* b,
                            int64_t nb) {
    std::vector<int64_t> prev(nb + 1), cur(nb + 1);
    for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
    for (int64_t i = 1; i <= na; ++i) {
        cur[0] = i;
        for (int64_t j = 1; j <= nb; ++j)
            cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1,
                               prev[j - 1] + (b[j - 1] != a[i - 1])});
        prev.swap(cur);
    }
    return prev[nb];
}

void code_to_digits(int64_t code, int64_t k, uint8_t* out) {
    for (int64_t i = k - 1; i >= 0; --i) {
        out[i] = (uint8_t)(code & 3);
        code >>= 2;
    }
}

// searchPANode / searchPANode2 (walk.py:322-351)
void search_pa_node(Handle* h, const int64_t* a_nodes,
                    const int64_t* a_qpos, int64_t n_anodes,
                    bool only_first, int64_t chosen_signed,
                    int64_t center, bool center_is_qp,
                    bool has_window, int64_t win_lo, int64_t win_hi,
                    std::vector<std::pair<int64_t, int64_t>>& out) {
    out.clear();
    std::unordered_set<int64_t> unique;
    for (int64_t ai = 0; ai < n_anodes; ++ai) {
        int64_t nd = a_nodes[ai], qp = a_qpos[ai];
        if (has_window) {
            if (qp < win_lo) continue;
            if (qp > win_hi) break;
        }
        for (int64_t pi = h->pos_start[nd]; pi < h->pos_start[nd + 1];
             ++pi) {
            if (h->used[pi]) continue;
            if (unique.count(pi)) continue;
            int64_t ci, cp;
            h->ctg_map.s2d((int64_t)h->pos_ctg[pi], &ci, &cp);
            int64_t ref = center_is_qp ? qp : center;
            if (ci == chosen_signed
                && std::llabs(cp - ref) <= h->deviation) {
                out.push_back({nd, pi});
                unique.insert(pi);
            }
        }
        if (!out.empty() && only_first) break;
    }
}

int64_t seq_len(const std::vector<Step>& s) {
    int64_t t = 0;
    for (const Step& p : s) t += p.dist;
    return t;
}

// appendSeq (walk.py:478-498)
int64_t append_seq(Handle* h, std::vector<Step>& base,
                   const std::vector<Step>& tail) {
    if (tail.empty()) return 0;
    int64_t d_len = 0;
    int64_t head_c = (int64_t)h->pos_ctg[tail[0].pos];
    int64_t dist = h->k;
    while (!base.empty()
           && ((int64_t)h->pos_ctg[base.back().pos] == 0
               || head_c <= (int64_t)h->pos_ctg[base.back().pos])) {
        d_len -= base.back().dist;
        base.pop_back();
    }
    if (!base.empty())
        dist = head_c - (int64_t)h->pos_ctg[base.back().pos];
    for (const Step& p : tail) {
        d_len += p.dist;
        base.push_back(p);
    }
    size_t first_tail = base.size() - tail.size();
    d_len -= base[first_tail].dist - dist;
    base[first_tail].dist = dist;
    return d_len;
}

// filterSequence (walk.py:354-365)
void filter_sequence(Handle* h, std::vector<Step>& seq) {
    const int64_t window = 10;
    int64_t n = (int64_t)seq.size();
    if (n < window) return;
    int64_t start_idx = n - n / 90;
    for (int64_t i = start_idx; i <= n - window; ++i) {
        int64_t first = (int64_t)h->pos_ctg[seq[i].pos];
        int64_t second =
            (int64_t)h->pos_ctg[seq[std::min(n, i + window) - 1].pos];
        if (second != 0 && first != 0 && second < first) {
            seq.resize((size_t)(i + 1));
            return;
        }
    }
}

}  // namespace

extern "C" {

void* agt_create(
    int64_t n_nodes, int64_t n_pos, int64_t k,
    const int64_t* node_codes, const int64_t* pos_start,
    const uint32_t* pos_ctg, const uint32_t* pos_ref,
    const uint16_t* pos_count, const uint8_t* used,
    const int64_t* edge_start, const int32_t* edge_to,
    const int32_t* edge_step,
    int64_t ctg_n, const int64_t* ctg_lengths, const int64_t* ctg_starts,
    int64_t ref_n, const int64_t* ref_lengths, const int64_t* ref_starts,
    int64_t deviation, double error_rate, double start_split,
    int64_t min_len, int64_t top_k, int64_t walk_threads) {
    Handle* h = new Handle();
    h->n_nodes = n_nodes;
    h->n_pos = n_pos;
    h->k = k;
    h->node_codes = node_codes;
    h->pos_start = pos_start;
    h->pos_ctg = pos_ctg;
    h->pos_ref = pos_ref;
    h->pos_count = pos_count;
    h->used = used;
    h->edge_start = edge_start;
    h->edge_to = edge_to;
    h->edge_step = edge_step;
    h->ctg_map = {ctg_n, ctg_lengths, ctg_starts};
    h->ref_map = {ref_n, ref_lengths, ref_starts};
    h->deviation = deviation;
    h->error_rate = error_rate;
    h->start_split = start_split;
    h->min_len = min_len;
    h->top_k = top_k;
    if (walk_threads <= 0)
        walk_threads = (int64_t)std::thread::hardware_concurrency();
    h->walk_threads =
        (int)std::max((int64_t)1, std::min(walk_threads, top_k));
    h->build_thr_table(edge_start[n_nodes]);
    return h;
}

void agt_destroy(void* hp) { delete (Handle*)hp; }

// travelSequence (walk.py:368-475).  Returns the number of steps; the
// output arrays are malloc'd into *out_nodes/*out_pos/*out_dist (freed
// with agt_free).
int64_t agt_travel(void* hp, int64_t ctg_idx, int forward,
                   const int64_t* a_nodes, const int64_t* a_qpos,
                   int64_t n_anodes, int64_t ctg_len,
                   int64_t** out_nodes, int64_t** out_pos,
                   int64_t** out_dist) {
    Handle* h = (Handle*)hp;
    Workspace* ws = h->acquire();
    Level* gl = &ws->gl;
    gl->init(h->n_pos);
    gl->new_epoch();
    int64_t chosen_signed = forward ? (ctg_idx + 1) : -(ctg_idx + 1);
    int64_t split_len = (int64_t)((double)ctg_len * h->start_split);
    double split_min = 1.0 - h->start_split;

    int64_t ctg_left = h->ctg_map.d2s(chosen_signed, 0);
    int64_t ctg_right = h->ctg_map.d2s(chosen_signed, ctg_len);
    int64_t rev_range[2] = {h->ctg_map.d2s(-chosen_signed, 0),
                            h->ctg_map.d2s(-chosen_signed, ctg_len)};

    std::vector<std::pair<int64_t, int64_t>> pa_nodes;
    search_pa_node(h, a_nodes, a_qpos, n_anodes, true, chosen_signed,
                   0, true, false, 0, 0, pa_nodes);
    if ((int64_t)pa_nodes.size() > h->top_k)
        pa_nodes.resize((size_t)h->top_k);

    std::vector<Step> travel;
    int64_t var_len = 0;
    std::vector<int64_t> ctg_que, ref_que;
    bool final_leap = false;
    std::vector<Step> seq_buf;
    std::vector<uint8_t> kmer1((size_t)h->k), kmer2((size_t)h->k);

    while (!pa_nodes.empty()) {
        std::vector<std::vector<Step>> seqs(pa_nodes.size());
        // the <= top_k seed walks run in parallel (PAlgorithm.cpp:230);
        // each walk thread owns its travel/walk levels, gl is read-only
        // during walks, and the selection below consumes seqs in index
        // order — results are bit-identical to the serial loop
        int T = (int)std::min((size_t)h->walk_threads, pa_nodes.size());
        auto walk_range = [&](int t) {
            Level* tl = &ws->tls[(size_t)t];
            Level* wl = &ws->wls[(size_t)t];
            tl->init(h->n_pos);
            wl->init(h->n_pos);
            for (size_t i = (size_t)t; i < pa_nodes.size(); i += (size_t)T)
                graph_travel(h, gl, tl, wl, pa_nodes[i].first,
                             pa_nodes[i].second, ctg_left, ctg_right,
                             var_len, split_len, split_min, rev_range,
                             seqs[i]);
        };
        if (T > 1) {
            std::vector<std::thread> pool;
            pool.reserve((size_t)T);
            for (int t = 0; t < T; ++t)
                pool.emplace_back(walk_range, t);
            for (auto& th : pool) th.join();
        } else {
            walk_range(0);
        }
        std::vector<Step> longest;
        int64_t max_len = 0, choose_ctg = 0, choose_ref = 0;
        bool leap = false;
        for (size_t i = 0; i < pa_nodes.size(); ++i) {
            const std::vector<Step>& seq = seqs[i];
            int64_t ln = seq_len(seq);
            int64_t last_c = (int64_t)h->pos_ctg[seq.back().pos];
            int64_t di, dp;
            h->ctg_map.s2d(last_c, &di, &dp);
            leap = last_c != 0 && di != chosen_signed;
            if (!leap && i > 0 && h->min_len > 0 && ln < h->min_len)
                continue;
            if (ln > max_len || leap) {
                max_len = ln;
                longest = seq;
                int64_t ci, cp, ri, rp;
                h->ctg_map.s2d((int64_t)h->pos_ctg[pa_nodes[i].second],
                               &ci, &cp);
                h->ref_map.s2d((int64_t)h->pos_ref[pa_nodes[i].second],
                               &ri, &rp);
                choose_ctg = cp;
                choose_ref = rp;
                if (leap) break;
            }
        }
        var_len += append_seq(h, travel, longest);
        if (choose_ctg != 0) {
            ctg_que.push_back(choose_ctg);
            if (ctg_que.size() > 4)
                ctg_que.erase(ctg_que.begin(),
                              ctg_que.end() - 4);
        }
        if (choose_ref != 0) {
            ref_que.push_back(choose_ref);
            if (ref_que.size() > 4)
                ref_que.erase(ref_que.begin(),
                              ref_que.end() - 4);
        }
        for (const Step& p : longest) {
            gl->add(p.pos);
            gl->table.insert((int64_t)h->pos_ctg[p.pos]);
        }
        auto spread = [&](const std::vector<int64_t>& q) {
            if (q.size() < 4) return false;
            int64_t lo = q[0], hi = q[0];
            for (int64_t v : q) { lo = std::min(lo, v); hi = std::max(hi, v); }
            return hi - lo <= 2 * h->deviation;
        };
        if (spread(ctg_que) || spread(ref_que) || leap) {
            final_leap = leap;
            break;
        }

        // re-seed near the last contig anchor (walk.py:443-465)
        int64_t last_ctg_pos = 0;
        int64_t last_kmer_node = -1;
        for (auto it = travel.rbegin(); it != travel.rend(); ++it) {
            if ((int64_t)h->pos_ctg[it->pos] == 0) continue;
            int64_t ci, cp;
            h->ctg_map.s2d((int64_t)h->pos_ctg[it->pos], &ci, &cp);
            if (ci == chosen_signed && cp >= 0) {
                last_ctg_pos = cp;
                last_kmer_node = it->node;
                break;
            }
        }
        int64_t win_lo = last_ctg_pos
            - std::min(last_ctg_pos, 1000 * h->deviation);
        int64_t win_hi = last_ctg_pos + 1000 * h->deviation;
        search_pa_node(h, a_nodes, a_qpos, n_anodes, false, chosen_signed,
                       last_ctg_pos, false, true, win_lo, win_hi, pa_nodes);
        // drop already-visited, rank by kmer edit distance (stable)
        std::vector<std::pair<int64_t, int64_t>> filt;
        for (auto& p : pa_nodes)
            if (!gl->member(p.second)) filt.push_back(p);
        std::vector<int64_t> ed(filt.size());
        if (last_kmer_node >= 0)
            code_to_digits(h->node_codes[last_kmer_node], h->k,
                           kmer1.data());
        for (size_t i = 0; i < filt.size(); ++i) {
            if (last_kmer_node < 0) { ed[i] = h->k; continue; }
            code_to_digits(h->node_codes[filt[i].first], h->k,
                           kmer2.data());
            ed[i] = edit_distance_codes(kmer1.data(), h->k, kmer2.data(),
                                        h->k);
        }
        std::vector<size_t> order(filt.size());
        for (size_t i = 0; i < order.size(); ++i) order[i] = i;
        std::stable_sort(order.begin(), order.end(),
                         [&](size_t a, size_t b) { return ed[a] < ed[b]; });
        pa_nodes.clear();
        for (size_t i = 0; i < order.size()
             && (int64_t)pa_nodes.size() < h->top_k; ++i)
            pa_nodes.push_back(filt[order[i]]);
    }

    if (!final_leap) filter_sequence(h, travel);
    if (final_leap && !travel.empty()) {
        int64_t di, dp;
        h->ctg_map.s2d((int64_t)h->pos_ctg[travel.back().pos], &di, &dp);
        int64_t tgt_len = di != 0 ? h->ctg_map.seq_size(di) : 0;
        if (std::llabs(di) == ctg_idx + 1
            || (double)dp >= (double)tgt_len * (1.0 - h->start_split))
            travel.pop_back();
    }

    h->release(ws);
    int64_t n = (int64_t)travel.size();
    *out_nodes = (int64_t*)std::malloc(sizeof(int64_t) * std::max(n, (int64_t)1));
    *out_pos = (int64_t*)std::malloc(sizeof(int64_t) * std::max(n, (int64_t)1));
    *out_dist = (int64_t*)std::malloc(sizeof(int64_t) * std::max(n, (int64_t)1));
    for (int64_t i = 0; i < n; ++i) {
        (*out_nodes)[i] = travel[(size_t)i].node;
        (*out_pos)[i] = travel[(size_t)i].pos;
        (*out_dist)[i] = travel[(size_t)i].dist;
    }
    return n;
}

void agt_free(int64_t* p) { std::free(p); }

}  // extern "C"
