// Copy of aligngraph2_tpu/native/poacns.cpp, built with the same flags
// (consensus/native.py).  The port binds agp_consensus_backbone; the
// device-consensus entry points below come with the device consensus.
//
// Native consensus core for the pa_cns stage.
//
// Implements the full per-backbone flow of
// AlignGraph2 PAGraph/src/main/pa_cns.cpp:12-168 +
// tools/cns/{AlignData.cpp,AlnGraphBoost.cpp,Alignment.cpp}:
// window slicing (gap-aware sliceHelper), dagcon gap normalization,
// per-window stable top-K by score, min-max score weights capped at
// alpha, POA graph build / node merging / backward best-path DP, and
// window concatenation.
//
// The semantics mirror aligngraph2_tpu/consensus/{poa.py,window.py}
// EXACTLY (bit-identical output) — the Python modules are the readable
// specification and the parity oracle; this library is the production
// path (one call per backbone, windows processed by std::thread).
//
// Adjacency uses insertion-ordered edge lists (vector<pair>) to match
// Python dict iteration order, which the best-path strict-'>' tie
// break depends on.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <string>
#include <thread>
#include <unordered_set>
#include <vector>

namespace {

using std::int64_t;
using EdgeList = std::vector<std::pair<int, int64_t>>;  // (node, count)

inline int64_t* find_edge(EdgeList& es, int v) {
    for (auto& e : es)
        if (e.first == v) return &e.second;
    return nullptr;
}

inline void add_or_inc(EdgeList& es, int v, int64_t w) {
    if (int64_t* c = find_edge(es, v)) *c += w;
    else es.emplace_back(v, w);
}

inline void erase_edge(EdgeList& es, int v) {
    for (size_t i = 0; i < es.size(); ++i)
        if (es[i].first == v) { es.erase(es.begin() + i); return; }
}

// ---- dagcon normalizeGaps (consensus/poa.py:normalize_gaps) ----
void normalize_gaps(const std::string& qs, const std::string& ts,
                    std::string& fq, std::string& ft) {
    const size_t m = qs.size();
    std::string qn, tn;
    qn.reserve(m + 16);
    tn.reserve(m + 16);
    for (size_t i = 0; i < m; ++i) {
        char qb = qs[i] == '.' ? '-' : qs[i];
        char tb = ts[i] == '.' ? '-' : ts[i];
        if (qb != tb && qb != '-' && tb != '-') {
            qn.push_back('-'); qn.push_back(qb);
            tn.push_back(tb);  tn.push_back('-');
        } else {
            qn.push_back(qb);
            tn.push_back(tb);
        }
    }
    const size_t n = qn.size();
    if (n) {
        for (size_t i = 0; i + 1 < n; ++i) {
            if (tn[i] == '-') {
                for (size_t j = i + 1; j < n; ++j) {
                    char c = tn[j];
                    if (c != '-') {
                        if (c == qn[i]) { tn[i] = c; tn[j] = '-'; }
                        break;
                    }
                }
            }
            if (qn[i] == '-') {
                for (size_t j = i + 1; j < n; ++j) {
                    char c = qn[j];
                    if (c != '-') {
                        if (c == tn[i]) { qn[i] = c; qn[j] = '-'; }
                        break;
                    }
                }
            }
        }
    }
    fq.clear(); ft.clear();
    fq.reserve(n); ft.reserve(n);
    for (size_t i = 0; i < n; ++i) {
        if (qn[i] != '-' || tn[i] != '-') {
            fq.push_back(qn[i]);
            ft.push_back(tn[i]);
        }
    }
}

// ---- AlignData::sliceHelper (consensus/window.py:_slice_helper) ----
void slice_helper(const char* tstr, int64_t tlen, int64_t origin_start,
                  int64_t slice_start, int64_t slice_end,
                  int64_t* lo, int64_t* hi) {
    int64_t cnt = 0, left = 0;
    while (left < tlen) {
        if (tstr[left] == '-') { ++left; continue; }
        if (origin_start + cnt >= slice_start) break;
        ++cnt; ++left;
    }
    int64_t right = left;
    while (right < tlen) {
        if (tstr[right] == '-') { ++right; continue; }
        if (origin_start + cnt >= slice_end) break;
        ++cnt; ++right;
    }
    *lo = left;
    *hi = right;
}

// ---- AlnGraphBoost (consensus/poa.py:AlnGraph) ----
struct AlnGraph {
    static constexpr int ENTER = 0;
    int exit_;
    std::vector<char> base;
    std::vector<int64_t> weight, coverage;
    std::vector<int> bbpos;
    std::vector<bool> backbone, deleted;
    std::vector<EdgeList> out, in_;

    explicit AlnGraph(const std::string& bb) {
        const int blen = (int)bb.size();
        exit_ = blen + 1;
        const int n = blen + 2;
        base.resize(n);
        base[0] = '^';
        for (int i = 0; i < blen; ++i) base[i + 1] = bb[i];
        base[n - 1] = '$';
        weight.assign(n, 0);
        for (int i = 1; i <= blen; ++i) weight[i] = 1;
        coverage.assign(n, 0);
        backbone.assign(n, true);
        bbpos.resize(n);
        for (int i = 0; i < n; ++i) bbpos[i] = i;
        deleted.assign(n, false);
        out.resize(n);
        in_.resize(n);
        for (int i = 0; i < blen + 1; ++i) {
            out[i].emplace_back(i + 1, 0);
            in_[i + 1].emplace_back(i, 0);
        }
    }

    int new_node(char b, int bp) {
        base.push_back(b);
        weight.push_back(0);
        coverage.push_back(0);
        backbone.push_back(false);
        bbpos.push_back(bp);
        deleted.push_back(false);
        out.emplace_back();
        in_.emplace_back();
        return (int)base.size() - 1;
    }

    void add_edge(int u, int v, int64_t w) {
        add_or_inc(out[u], v, w);
        add_or_inc(in_[v], u, w);
    }

    void add_aln(int64_t start, const std::string& qs,
                 const std::string& ts, int64_t w) {
        if (w <= 0) return;
        int bb = (int)start;
        int prev = ENTER;
        const size_t n = qs.size();
        for (size_t i = 0; i < n; ++i) {
            char qb = qs[i], tb = ts[i];
            if (qb == tb) {
                int cur = bb;
                coverage[bbpos[cur]] += w;
                weight[cur] += w;
                add_edge(prev, cur, w);
                ++bb;
                prev = cur;
            } else if (qb == '-' && tb != '-') {
                coverage[bbpos[bb]] += w;
                ++bb;
            } else if (qb != '-' && tb == '-') {
                int cur = new_node(qb, bb);
                weight[cur] += w;
                add_edge(prev, cur, w);
                prev = cur;
            }
        }
        add_edge(prev, exit_, w);
    }

    static inline uint64_t key(int a, int b) {
        return ((uint64_t)(uint32_t)a << 32) | (uint32_t)b;
    }

    void reap(int n) {
        deleted[n] = true;
        for (auto& e : in_[n]) erase_edge(out[e.first], n);
        for (auto& e : out[n]) erase_edge(in_[e.first], n);
        in_[n].clear();
        out[n].clear();
    }

    void merge_in_nodes(int n) {
        // group in-neighbours with a single out edge by base, first-seen
        // order (Python dict-of-lists semantics)
        std::vector<std::pair<char, std::vector<int>>> groups;
        for (auto& e : in_[n]) {
            int src = e.first;
            if (out[src].size() == 1) {
                char b = base[src];
                bool found = false;
                for (auto& g : groups)
                    if (g.first == b) { g.second.push_back(src); found = true; break; }
                if (!found) groups.push_back({b, {src}});
            }
        }
        for (auto& g : groups) {
            auto& nodes = g.second;
            if (nodes.size() <= 1) continue;
            std::sort(nodes.begin(), nodes.end());
            int an = nodes[0];
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                int64_t c_ni = out[ni][0].second;
                int tgt = out[an][0].first;
                out[an][0].second += c_ni;
                *find_edge(in_[tgt], an) += c_ni;
                weight[an] += weight[ni];
            }
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                for (auto& e : in_[ni]) {
                    add_or_inc(in_[an], e.first, e.second);
                    add_or_inc(out[e.first], an, e.second);
                }
                reap(ni);
            }
            merge_in_nodes(an);
        }
    }

    void merge_out_nodes(int n) {
        std::vector<std::pair<char, std::vector<int>>> groups;
        for (auto& e : out[n]) {
            int tgt = e.first;
            if (in_[tgt].size() == 1) {
                char b = base[tgt];
                bool found = false;
                for (auto& g : groups)
                    if (g.first == b) { g.second.push_back(tgt); found = true; break; }
                if (!found) groups.push_back({b, {tgt}});
            }
        }
        for (auto& g : groups) {
            auto& nodes = g.second;
            if (nodes.size() <= 1) continue;
            std::sort(nodes.begin(), nodes.end());
            int an = nodes[0];
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                int64_t c_ni = in_[ni][0].second;
                int src = in_[an][0].first;
                in_[an][0].second += c_ni;
                *find_edge(out[src], an) += c_ni;
                weight[an] += weight[ni];
            }
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                for (auto& e : out[ni]) {
                    add_or_inc(out[an], e.first, e.second);
                    add_or_inc(in_[e.first], an, e.second);
                }
                reap(ni);
            }
        }
    }

    void merge_nodes() {
        std::unordered_set<uint64_t> visited;
        std::deque<int> queue{ENTER};
        while (!queue.empty()) {
            int u = queue.front();
            queue.pop_front();
            merge_in_nodes(u);
            merge_out_nodes(u);
            // snapshot (Python iterates list(self.out[u]))
            EdgeList snapshot = out[u];
            for (auto& e : snapshot) {
                int v = e.first;
                visited.insert(key(u, v));
                bool all_in = true;
                for (auto& ie : in_[v])
                    if (!visited.count(key(ie.first, v))) { all_in = false; break; }
                if (all_in) queue.push_back(v);
            }
        }
    }

    std::vector<int> best_path() const {
        const int N = (int)base.size();
        std::vector<double> node_score(N, 0.0);
        std::vector<int> best_edge(N, -1);
        std::unordered_set<uint64_t> visited;
        std::deque<int> queue{exit_};
        while (!queue.empty()) {
            int n = queue.front();
            queue.pop_front();
            bool best_found = false;
            double best_score = -1e300;
            int best_tgt = -1;
            for (auto& e : out[n]) {
                int tgt = e.first;
                double score = node_score[tgt];
                double ns;
                if (backbone[tgt] && weight[tgt] == 1)
                    ns = score - 10.0;
                else
                    ns = (double)e.second - coverage[bbpos[tgt]] * 0.5 + score;
                if (ns > best_score) {
                    best_score = ns;
                    best_tgt = tgt;
                    best_found = true;
                }
            }
            if (best_found) {
                node_score[n] = best_score;
                best_edge[n] = best_tgt;
            }
            for (auto& e : in_[n]) {
                int src = e.first;
                visited.insert(key(src, n));
                bool all_out = true;
                for (auto& oe : out[src])
                    if (!visited.count(key(src, oe.first))) { all_out = false; break; }
                if (all_out) queue.push_back(src);
            }
        }
        std::vector<int> path;
        int prev = ENTER;
        for (;;) {
            path.push_back(prev);
            if (best_edge[prev] < 0) break;
            prev = best_edge[prev];
        }
        return path;
    }

    std::string consensus(int64_t min_weight) const {
        std::vector<int> path = best_path();
        std::string cns;
        std::vector<int64_t> ws;
        for (int n : path) {
            if (base[n] == '^' || base[n] == '$') continue;
            cns.push_back(base[n]);
            ws.push_back(weight[n]);
        }
        int64_t offs = 0, best_offs = 0, length = 0, idx = 0;
        bool met = false;
        for (int64_t w : ws) {
            if (!met && w >= min_weight) {
                offs = idx;
                met = true;
            } else if (met && w < min_weight) {
                if (idx - offs > length) { best_offs = offs; length = idx - offs; }
                met = false;
            }
            ++idx;
        }
        if (met && idx - offs > length) { best_offs = offs; length = idx - offs; }
        return cns.substr((size_t)best_offs, (size_t)length);
    }
};

struct WindowAln {
    int64_t start;  // 1-based window-local backbone start
    int64_t score;
    std::string qstr, tstr;
};

// Shared by agp_consensus_backbone and agp_encode_windows: window
// slicing (window.py:slice_into_windows semantics).
void build_parts(const char* backbone, int64_t blen, int64_t n_alns,
                 const int64_t* rb, const int64_t* re,
                 const int64_t* score, const char* const* qstrs,
                 const char* const* tstrs, int64_t window,
                 std::vector<std::vector<WindowAln>>& parts) {
    const int64_t part_num = (blen + window - 1) / window;
    parts.assign((size_t)part_num, {});
    for (int64_t a = 0; a < n_alns; ++a) {
        const int64_t ts = rb[a], te = re[a];
        if (te <= ts) continue;
        const int64_t left_part = ts / window;
        const int64_t right_part = std::min((te - 1) / window, part_num - 1);
        const char* tstr = tstrs[a];
        const int64_t tlen = (int64_t)std::strlen(tstr);
        for (int64_t i = left_part; i <= right_part; ++i) {
            const int64_t start =
                (i == left_part) ? ts - left_part * window + 1 : 1;
            int64_t lo, hi;
            slice_helper(tstr, tlen, ts, i * window,
                         std::min((i + 1) * window, blen), &lo, &hi);
            if (hi <= lo) continue;
            std::string qs(qstrs[a] + lo, qstrs[a] + hi);
            std::string tw(tstr + lo, tstr + hi);
            WindowAln wa;
            wa.start = start;
            wa.score = score[a];
            normalize_gaps(qs, tw, wa.qstr, wa.tstr);
            parts[(size_t)i].push_back(std::move(wa));
        }
    }
}

// Stable top-k by score + min-max weights (window.py:weight_alignments).
void topk_and_weights(std::vector<WindowAln>& part, int64_t top_k,
                      int64_t alpha, std::vector<int64_t>& ws) {
    std::stable_sort(part.begin(), part.end(),
                     [](const WindowAln& a, const WindowAln& b) {
                         return a.score > b.score;
                     });
    if ((int64_t)part.size() > top_k) part.resize((size_t)top_k);
    ws.assign(part.size(), 0);
    if (!part.empty()) {
        int64_t lo = part[0].score, hi = part[0].score;
        for (auto& p : part) {
            lo = std::min(lo, p.score);
            hi = std::max(hi, p.score);
        }
        double rng = std::max((double)(hi - lo), 1.0);
        for (size_t j = 0; j < part.size(); ++j) {
            int64_t w = (int64_t)(((double)(part[j].score - lo) / rng) *
                                  (double)alpha);
            ws[j] = std::max(w, (int64_t)1);
        }
    }
}

}  // namespace

extern "C" {

// One call per backbone.  Returns 0 on success; *out is malloc'd (free
// with agp_free), *out_len its length.
int agp_consensus_backbone(
    const char* backbone, int64_t blen,
    int64_t n_alns,
    const int64_t* rb, const int64_t* re, const int64_t* score,
    const char* const* qstrs, const char* const* tstrs,
    int64_t window, int64_t top_k, int64_t alpha, int64_t min_weight,
    int64_t threads,
    char** out, int64_t* out_len) {
    if (blen <= 0 || window <= 0) {
        *out = (char*)std::malloc(1);
        (*out)[0] = 0;
        *out_len = 0;
        return 0;
    }
    const int64_t part_num = (blen + window - 1) / window;
    std::vector<std::vector<WindowAln>> parts;
    build_parts(backbone, blen, n_alns, rb, re, score, qstrs, tstrs,
                window, parts);

    // --- per-window consensus ---
    std::vector<std::string> results((size_t)part_num);
    auto one = [&](int64_t i) {
        auto& part = parts[(size_t)i];
        const int64_t left = i * window;
        const int64_t right = std::min((i + 1) * window, blen);
        std::string skeleton(backbone + left, backbone + right);
        std::vector<int64_t> ws;
        topk_and_weights(part, top_k, alpha, ws);
        AlnGraph g(skeleton);
        for (size_t j = 0; j < part.size(); ++j)
            g.add_aln(part[j].start, part[j].qstr, part[j].tstr, ws[j]);
        g.merge_nodes();
        results[(size_t)i] = g.consensus(min_weight);
    };

    const int64_t nthreads =
        std::max<int64_t>(1, std::min(threads, part_num));
    if (nthreads > 1) {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < nthreads; ++t)
            pool.emplace_back([&, t] {
                for (int64_t i = t; i < part_num; i += nthreads) one(i);
            });
        for (auto& th : pool) th.join();
    } else {
        for (int64_t i = 0; i < part_num; ++i) one(i);
    }

    size_t total = 0;
    for (auto& r : results) total += r.size();
    char* buf = (char*)std::malloc(total + 1);
    if (!buf) return 1;
    size_t off = 0;
    for (auto& r : results) {
        std::memcpy(buf + off, r.data(), r.size());
        off += r.size();
    }
    buf[total] = 0;
    *out = buf;
    *out_len = (int64_t)total;
    return 0;
}

void agp_free(char* p) { std::free(p); }

// ---------------------------------------------------------------------
// Device consensus path, host side (see consensus/device.py):
//   agp_encode_windows   — slice/normalize/top-k/weight + flatten to the
//                          op stream + chain records the device kernels
//                          consume (spec: consensus/device.py
//                          encode_windows_np, bit-identical streams)
//   agp_reduced_consensus— order-keyed mergeNodes/bestPath on the
//                          reduced graph (spec: consensus/reduced.py
//                          _RGraph)
// ---------------------------------------------------------------------

int agp_encode_windows(
    const char* backbone, int64_t blen,
    int64_t n_alns,
    const int64_t* rb, const int64_t* re, const int64_t* score,
    const char* const* qstrs, const char* const* tstrs,
    int64_t window, int64_t top_k, int64_t alpha,
    int64_t* n_windows_out, int64_t* stride_out,
    uint8_t** ops_out, int64_t* n_cols_out,
    int32_t** col2seg_out,
    int32_t** seg_meta_out, int64_t* n_segs_out,
    int32_t** seg_off_out,
    int32_t** win_col_off_out, int32_t** win_exit_out,
    int32_t** chains_out, int64_t* n_chains_out) {
    if (blen <= 0 || window <= 0) return 1;
    const int64_t nw = (blen + window - 1) / window;
    std::vector<std::vector<WindowAln>> parts;
    build_parts(backbone, blen, n_alns, rb, re, score, qstrs, tstrs,
                window, parts);

    std::vector<uint8_t> ops;
    std::vector<int32_t> col2seg, seg_meta, seg_off{0};
    std::vector<int32_t> win_col_off((size_t)nw + 1), win_exit((size_t)nw);
    std::vector<int32_t> chains;  // 15 fields per record
    int64_t stride = 0;
    for (int64_t wi = 0; wi < nw; ++wi) {
        int64_t sk_len = std::min(window, blen - wi * window);
        stride = std::max(stride, sk_len + 2);
    }
    int64_t gcol = 0;
    for (int64_t wi = 0; wi < nw; ++wi) {
        win_col_off[(size_t)wi] = (int32_t)gcol;
        const int64_t sk_len = std::min(window, blen - wi * window);
        win_exit[(size_t)wi] = (int32_t)(sk_len + 1);
        auto& part = parts[(size_t)wi];
        std::vector<int64_t> ws;
        topk_and_weights(part, top_k, alpha, ws);
        int64_t t = 0, creation = 0;
        for (size_t j = 0; j < part.size(); ++j) {
            const int64_t w = ws[j];
            if (w <= 0) continue;
            const int32_t seg_id = (int32_t)(seg_off.size() - 1);
            seg_meta.push_back((int32_t)wi);
            seg_meta.push_back((int32_t)part[j].start);
            seg_meta.push_back((int32_t)w);
            const std::string& qs = part[j].qstr;
            const std::string& tsr = part[j].tstr;
            const int64_t n = (int64_t)qs.size();
            int64_t bb = part[j].start;
            int64_t prev_match_bb = -1;
            bool in_chain = false, interior = false;
            int64_t ch_bb_start = 0, ch_ft_head = 0, ch_crea = 0;
            int64_t ch_col_start = 0, ch_prev = 0, ch_len = 0;
            uint32_t words[4] = {0, 0, 0, 0};
            auto close_chain = [&](int64_t next_anchor, int64_t ft_tail) {
                int32_t flags = interior ? 2 : 0;
                if (ch_len > 64) {
                    flags |= 1;
                    words[0] = (uint32_t)ch_col_start;
                    words[1] = words[2] = words[3] = 0;
                }
                chains.push_back((int32_t)wi);
                chains.push_back((int32_t)ch_prev);
                chains.push_back((int32_t)next_anchor);
                chains.push_back((int32_t)ch_len);
                for (int k = 0; k < 4; ++k)
                    chains.push_back((int32_t)words[k]);
                chains.push_back((int32_t)w);
                chains.push_back((int32_t)ch_crea);
                chains.push_back((int32_t)ch_ft_head);
                chains.push_back((int32_t)ft_tail);
                chains.push_back((int32_t)ch_col_start);
                chains.push_back((int32_t)ch_bb_start);
                chains.push_back(flags);
                in_chain = false;
                interior = false;
                words[0] = words[1] = words[2] = words[3] = 0;
                ch_len = 0;
            };
            for (int64_t i = 0; i < n; ++i) {
                const char qb = qs[(size_t)i], tb = tsr[(size_t)i];
                if (qb == tb) {
                    ops.push_back(1);
                    if (in_chain) close_chain(bb, 2 * (t + i));
                    ++bb;
                    prev_match_bb = bb - 1;
                } else if (qb == '-') {
                    ops.push_back(2);
                    if (in_chain) interior = true;
                    ++bb;
                } else {
                    int code = qb == 'C' ? 1 : qb == 'G' ? 2
                               : qb == 'T' ? 3 : 0;
                    ops.push_back((uint8_t)(3 | (code << 2)));
                    if (!in_chain) {
                        in_chain = true;
                        ch_prev = prev_match_bb >= 0 ? prev_match_bb : 0;
                        ch_bb_start = bb;
                        ch_ft_head = 2 * (t + i);
                        ch_crea = creation;
                        ch_col_start = gcol + i;
                        interior = false;
                    }
                    if (ch_len <= 63)
                        words[ch_len >> 4] |=
                            (uint32_t)code << (2 * (ch_len & 15));
                    ++ch_len;
                    ++creation;
                }
                col2seg.push_back(seg_id);
            }
            if (in_chain) close_chain(sk_len + 1, 2 * (t + n) - 1);
            gcol += n;
            t += n;
            seg_off.push_back((int32_t)gcol);
        }
    }
    win_col_off[(size_t)nw] = (int32_t)gcol;

    auto alloc_i32 = [](const std::vector<int32_t>& v) {
        int32_t* p = (int32_t*)std::malloc(
            std::max<size_t>(v.size(), 1) * sizeof(int32_t));
        if (p && !v.empty())
            std::memcpy(p, v.data(), v.size() * sizeof(int32_t));
        return p;
    };
    *n_windows_out = nw;
    *stride_out = stride;
    *n_cols_out = (int64_t)ops.size();
    uint8_t* po = (uint8_t*)std::malloc(std::max<size_t>(ops.size(), 1));
    if (po && !ops.empty()) std::memcpy(po, ops.data(), ops.size());
    *ops_out = po;
    *col2seg_out = alloc_i32(col2seg);
    *seg_meta_out = alloc_i32(seg_meta);
    *n_segs_out = (int64_t)(seg_meta.size() / 3);
    *seg_off_out = alloc_i32(seg_off);
    *win_col_off_out = alloc_i32(win_col_off);
    *win_exit_out = alloc_i32(win_exit);
    *chains_out = alloc_i32(chains);
    *n_chains_out = (int64_t)(chains.size() / 15);
    return 0;
}

namespace {

// Order-keyed reduced graph (spec: consensus/reduced.py::_RGraph).
struct RGraph {
    int exit_;
    std::vector<char> base;
    std::vector<int64_t> weight;
    std::vector<int32_t> bbpos;
    std::vector<bool> bb_flag, deleted;
    std::vector<int64_t> order;
    std::vector<EdgeList> out, in_;
    const int64_t* cov;     // dense per-window coverage [stride]

    void merge_in_nodes(int n) {
        std::vector<std::pair<char, std::vector<int>>> groups;
        for (auto& e : in_[n]) {
            int src = e.first;
            if (out[src].size() == 1) {
                char b = base[src];
                bool found = false;
                for (auto& g : groups)
                    if (g.first == b) { g.second.push_back(src);
                                        found = true; break; }
                if (!found) groups.push_back({b, {src}});
            }
        }
        for (auto& g : groups) {
            auto& nodes = g.second;
            if (nodes.size() <= 1) continue;
            std::sort(nodes.begin(), nodes.end(),
                      [&](int a, int b) { return order[a] < order[b]; });
            int an = nodes[0];
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                int64_t c_ni = out[ni][0].second;
                int tgt = out[an][0].first;
                out[an][0].second += c_ni;
                *find_edge(in_[tgt], an) += c_ni;
                weight[an] += weight[ni];
            }
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                for (auto& e : in_[ni]) {
                    add_or_inc(in_[an], e.first, e.second);
                    add_or_inc(out[e.first], an, e.second);
                }
                reap(ni);
            }
            merge_in_nodes(an);
        }
    }

    void merge_out_nodes(int n) {
        std::vector<std::pair<char, std::vector<int>>> groups;
        for (auto& e : out[n]) {
            int tgt = e.first;
            if (in_[tgt].size() == 1) {
                char b = base[tgt];
                bool found = false;
                for (auto& g : groups)
                    if (g.first == b) { g.second.push_back(tgt);
                                        found = true; break; }
                if (!found) groups.push_back({b, {tgt}});
            }
        }
        for (auto& g : groups) {
            auto& nodes = g.second;
            if (nodes.size() <= 1) continue;
            std::sort(nodes.begin(), nodes.end(),
                      [&](int a, int b) { return order[a] < order[b]; });
            int an = nodes[0];
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                int64_t c_ni = in_[ni][0].second;
                int src = in_[an][0].first;
                in_[an][0].second += c_ni;
                *find_edge(out[src], an) += c_ni;
                weight[an] += weight[ni];
            }
            for (size_t i = 1; i < nodes.size(); ++i) {
                int ni = nodes[i];
                for (auto& e : out[ni]) {
                    add_or_inc(out[an], e.first, e.second);
                    add_or_inc(in_[e.first], an, e.second);
                }
                reap(ni);
            }
        }
    }

    void reap(int n) {
        deleted[n] = true;
        for (auto& e : in_[n]) erase_edge(out[e.first], n);
        for (auto& e : out[n]) erase_edge(in_[e.first], n);
        in_[n].clear();
        out[n].clear();
    }

    static inline uint64_t key(int a, int b) {
        return ((uint64_t)(uint32_t)a << 32) | (uint32_t)b;
    }

    void merge_nodes() {
        std::unordered_set<uint64_t> visited;
        std::deque<int> queue{0};
        while (!queue.empty()) {
            int u = queue.front();
            queue.pop_front();
            merge_in_nodes(u);
            merge_out_nodes(u);
            EdgeList snapshot = out[u];
            for (auto& e : snapshot) {
                int v = e.first;
                visited.insert(key(u, v));
                bool all_in = true;
                for (auto& ie : in_[v])
                    if (!visited.count(key(ie.first, v))) {
                        all_in = false; break;
                    }
                if (all_in) queue.push_back(v);
            }
        }
    }

    std::string consensus(int64_t min_weight) const {
        const int N = (int)base.size();
        std::vector<double> node_score(N, 0.0);
        std::vector<int> best_edge(N, -1);
        std::unordered_set<uint64_t> visited;
        std::deque<int> queue{exit_};
        while (!queue.empty()) {
            int n = queue.front();
            queue.pop_front();
            bool best_found = false;
            double best_score = -1e300;
            int best_tgt = -1;
            for (auto& e : out[n]) {
                int tgt = e.first;
                double score = node_score[tgt];
                double ns;
                if (bb_flag[tgt] && weight[tgt] == 1)
                    ns = score - 10.0;
                else
                    ns = (double)e.second - cov[bbpos[tgt]] * 0.5 + score;
                if (ns > best_score) {
                    best_score = ns;
                    best_tgt = tgt;
                    best_found = true;
                }
            }
            if (best_found) {
                node_score[n] = best_score;
                best_edge[n] = best_tgt;
            }
            for (auto& e : in_[n]) {
                int src = e.first;
                visited.insert(key(src, n));
                bool all_out = true;
                for (auto& oe : out[src])
                    if (!visited.count(key(src, oe.first))) {
                        all_out = false; break;
                    }
                if (all_out) queue.push_back(src);
            }
        }
        std::string cns;
        std::vector<int64_t> wsv;
        int prev = 0;
        for (;;) {
            if (base[prev] != '^' && base[prev] != '$') {
                cns.push_back(base[prev]);
                wsv.push_back(weight[prev]);
            }
            if (best_edge[prev] < 0) break;
            prev = best_edge[prev];
        }
        int64_t offs = 0, best_offs = 0, length = 0, idx = 0;
        bool met = false;
        for (int64_t w : wsv) {
            if (!met && w >= min_weight) { offs = idx; met = true; }
            else if (met && w < min_weight) {
                if (idx - offs > length) { best_offs = offs;
                                           length = idx - offs; }
                met = false;
            }
            ++idx;
        }
        if (met && idx - offs > length) { best_offs = offs;
                                          length = idx - offs; }
        return cns.substr((size_t)best_offs, (size_t)length);
    }
};

}  // namespace

// chains layout per record: prev, next, len, w, creation, ft_head,
// ft_tail (7 int32); bases/bbpos streams are indexed by the running sum
// of len.  edges layout per record: u, v, count, ft (4 int32), in
// WindowTables dict-insertion order per window.
int agp_reduced_consensus(
    const char* backbone, int64_t blen, int64_t window,
    int64_t n_windows, int64_t stride,
    const int64_t* bb_wt, const int64_t* bb_cov,
    const int32_t* edges, const int64_t* edge_off,
    const int32_t* chains, const int64_t* chain_off,
    const char* chain_bases, const int32_t* chain_bbpos,
    const int64_t* chain_base_off,
    int64_t min_weight, int64_t threads,
    char** out, int64_t* out_len) {
    std::vector<std::string> results((size_t)n_windows);
    auto one = [&](int64_t wi) {
        const int64_t sk_len = std::min(window, blen - wi * window);
        RGraph g;
        const int n0 = (int)sk_len + 2;
        g.exit_ = (int)sk_len + 1;
        g.cov = bb_cov + wi * stride;
        g.base.resize(n0);
        g.base[0] = '^';
        for (int64_t i = 0; i < sk_len; ++i)
            g.base[(size_t)i + 1] = backbone[wi * window + i];
        g.base[(size_t)n0 - 1] = '$';
        g.weight.assign(n0, 0);
        for (int i = 0; i < n0; ++i)
            g.weight[(size_t)i] = bb_wt[wi * stride + i];
        for (int64_t i = 1; i <= sk_len; ++i) g.weight[(size_t)i] += 1;
        g.bbpos.resize(n0);
        for (int i = 0; i < n0; ++i) g.bbpos[(size_t)i] = i;
        g.bb_flag.assign(n0, true);
        g.deleted.assign(n0, false);
        g.order.resize(n0);
        for (int i = 0; i < n0; ++i) g.order[(size_t)i] = i;
        g.out.resize(n0);
        g.in_.resize(n0);

        // events: (ft, seq, u, v, count) — stable order = edges array
        // order then chain edges, exactly like _RGraph.__init__
        struct Ev { int64_t ft; int u, v; int64_t c; };
        std::vector<Ev> events;
        for (int64_t e = edge_off[wi]; e < edge_off[wi + 1]; ++e) {
            const int32_t* r = edges + 4 * e;
            events.push_back({(int64_t)r[3], (int)r[0], (int)r[1],
                              (int64_t)r[2]});
        }
        for (int64_t c = chain_off[wi]; c < chain_off[wi + 1]; ++c) {
            const int32_t* r = chains + 7 * c;
            const int prev = (int)r[0], nxt = (int)r[1];
            const int len = (int)r[2];
            const int64_t w = r[3], crea = r[4];
            const int64_t fth = r[5], ftt = r[6];
            const char* bs = chain_bases + chain_base_off[c];
            const int32_t* bp = chain_bbpos + chain_base_off[c];
            std::vector<int> ids((size_t)len);
            for (int j = 0; j < len; ++j) {
                int nid = (int)g.base.size();
                g.base.push_back(bs[j]);
                g.weight.push_back(w);
                g.bbpos.push_back(bp[j]);
                g.bb_flag.push_back(false);
                g.deleted.push_back(false);
                g.order.push_back((int64_t)n0 + crea + j);
                g.out.emplace_back();
                g.in_.emplace_back();
                ids[(size_t)j] = nid;
            }
            events.push_back({fth, prev, ids[0], w});
            for (int j = 0; j + 1 < len; ++j)
                events.push_back({fth, ids[(size_t)j],
                                  ids[(size_t)j + 1], w});
            events.push_back({ftt, ids[(size_t)len - 1], nxt, w});
        }
        std::stable_sort(events.begin(), events.end(),
                         [](const Ev& a, const Ev& b) {
                             return a.ft < b.ft;
                         });
        for (auto& ev : events) {
            g.out[(size_t)ev.u].emplace_back(ev.v, ev.c);
            g.in_[(size_t)ev.v].emplace_back(ev.u, ev.c);
        }
        g.merge_nodes();
        results[(size_t)wi] = g.consensus(min_weight);
    };
    const int64_t nthreads =
        std::max<int64_t>(1, std::min(threads, n_windows));
    if (nthreads > 1) {
        std::vector<std::thread> pool;
        for (int64_t t = 0; t < nthreads; ++t)
            pool.emplace_back([&, t] {
                for (int64_t i = t; i < n_windows; i += nthreads) one(i);
            });
        for (auto& th : pool) th.join();
    } else {
        for (int64_t i = 0; i < n_windows; ++i) one(i);
    }
    size_t total = 0;
    for (auto& r : results) total += r.size();
    char* buf = (char*)std::malloc(total + 1);
    if (!buf) return 1;
    size_t off = 0;
    for (auto& r : results) {
        std::memcpy(buf + off, r.data(), r.size());
        off += r.size();
    }
    buf[total] = 0;
    *out = buf;
    *out_len = (int64_t)total;
    return 0;
}

}  // extern "C"
