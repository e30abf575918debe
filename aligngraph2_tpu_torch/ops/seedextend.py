"""K-mer seeding and candidate selection for the seed-extend aligner.

Copy of ``aligngraph2_tpu/ops/seedextend.py``: seeding stays on the host,
in numpy and the native core of ``ops/native.py``.

Replaces the candidate-finding half of mecat2ref / mecat2ref+ (SURVEY.md
§2.5 C1/C2 — the mecat sources are absent submodules; semantics are
recovered from the observable contract and the published description:
the similar genome is scanned in blocks, candidate blocks are ranked by a
k-mer scoring function clamped to [alpha, beta], and alignments scoring
under delta are dropped, cf. AlignGraph2 README.md:43-51).

Concrete recovered semantics implemented here (documented because the
original binary is unrecoverable):

  * hits are (query_pos, target_pos) k-mer matches against a sorted-array
    index of the target database; k-mers occurring more than ``max_occ``
    times in the target are masked (standard long-read seeding practice).
  * hits are binned by (target_seq, diagonal // bin_w) with pair-of-bins
    smoothing; each surviving bin is a candidate alignment with an
    estimated diagonal.
  * the alpha/beta clamp: a candidate's ranking score is its hit count
    clamped to [alpha, beta] x the read's mean candidate hit count — alpha
    lifts weakly-seeded (diverged) blocks into consideration, beta stops
    repeat-rich blocks from crowding out the candidate list.
  * delta acts downstream (aligner.py): alignments scoring below
    delta x the read's best alignment score are dropped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..io.seqdb import SeqDatabase
from .kmer import kmer_codes_np


def effective_seed_k(cfg, target_db) -> int:
    """Auto-scaled seeding k for a target database.

    Per-read seeding cost at fixed k is linear in total target size
    (random hits/k-mer = G/4^k), which made the same-species aligner
    stages superlinear in dataset size.  Growing k with G keeps the
    noise-hit rate at or below ``seed_noise_rate``: 5 Mb stays at the
    configured seed_k, ~50 Mb moves to 15.  Recall is unaffected in the
    same-species regime (reads have thousands of surviving true seeds
    per candidate window at 15% error even at k=15); the diverged
    similar-genome stage is pinned by the driver via seed_k_auto=False.
    """
    if not getattr(cfg, "seed_k_auto", False):
        return cfg.seed_k
    total = int(target_db.lengths.sum()) if len(target_db) else 0
    k = cfg.seed_k
    k_max = max(cfg.seed_k, cfg.seed_k_max)
    while k < k_max and total > cfg.seed_noise_rate * (4 ** k):
        k += 1
    return k


class SeedIndex:
    """Sorted-array k-mer index over the forward strands of a SeqDatabase."""

    def __init__(self, db: SeqDatabase, k: int, max_occ: int = 256,
                 stride: int = 1):
        self.db = db
        self.k = k
        self.max_occ = max_occ
        codes_list = []
        pos_list = []
        for i in range(len(db)):
            c = kmer_codes_np(db.get_codes(i), k)
            if stride > 1:
                c = c[::stride]
                p = np.arange(0, len(c) * stride, stride, dtype=np.int64)
            else:
                p = np.arange(len(c), dtype=np.int64)
            codes_list.append(c)
            pos_list.append(p + db.offsets[i])  # global flat position
        codes = (np.concatenate(codes_list) if codes_list
                 else np.zeros(0, np.int64))
        pos = (np.concatenate(pos_list) if pos_list
               else np.zeros(0, np.int64))
        from .native import sort_codes_native
        if k <= 16 and sort_codes_native(codes, pos):
            # native stable radix co-sort (in place): ~25x the numpy
            # argsort at genome scale, identical ordering
            self.sorted_codes = codes
            self.sorted_pos = pos
        else:
            order = np.argsort(codes, kind="stable")
            self.sorted_codes = codes[order]
            self.sorted_pos = pos[order]
        # per-hit (target, local position) resolved once at build time:
        # the native binner gathers these directly instead of an
        # upper_bound over db offsets per hit (~15 ns x 100k hits/read
        # in the small-seed noise regime)
        if len(self.sorted_pos):
            tid = np.searchsorted(db.offsets, self.sorted_pos,
                                  side="right") - 1
            self.sorted_tid = tid.astype(np.int32)
            self.sorted_local = (self.sorted_pos
                                 - db.offsets[tid]).astype(np.int32)
        else:
            self.sorted_tid = np.zeros(0, np.int32)
            self.sorted_local = np.zeros(0, np.int32)
        # dense tables: O(1) lookup per query k-mer instead of a
        # cache-hostile binary search over the whole index (the
        # reference's kmer tables are dense too, kmer_counter.cpp:21-40).
        # dense_cnt (uint16) answers "how many hits" with one narrow
        # gather — max_occ masking is baked in at build time; dense_off
        # (int32) is only gathered for the k-mers that actually hit.
        self.dense_off = None
        self.dense_cnt = None
        # k = 14..16: a 2*prefix_len-bit prefix offset table over the
        # sorted codes gives the native binner O(1) range lookup per
        # query k-mer (within-prefix refinement is ~1 entry at practical
        # genome sizes).  Larger k keeps the noise-hit rate G/4^k flat
        # as targets grow — see effective_seed_k.
        self.prefix_off = None
        self.prefix_len = 0
        if 13 < k <= 16 and len(self.sorted_codes):
            self.prefix_len = 13
            shift = 2 * (k - self.prefix_len)
            size = 1 << (2 * self.prefix_len)
            pre = (self.sorted_codes >> shift).astype(np.int64)
            off = np.zeros(size + 1, np.int64)
            np.cumsum(np.bincount(pre, minlength=size), out=off[1:])
            self.prefix_off = off.astype(np.int32)
        if k <= 13 and len(self.sorted_codes):
            size = 1 << (2 * k)
            off = np.zeros(size + 1, np.int32)
            boundary = np.empty(len(self.sorted_codes), np.bool_)
            boundary[0] = True
            np.not_equal(self.sorted_codes[1:], self.sorted_codes[:-1],
                         out=boundary[1:])
            firsts = np.flatnonzero(boundary)
            uniq = self.sorted_codes[firsts]
            cnt = np.diff(np.append(firsts, len(self.sorted_codes)))
            off[uniq + 1] = cnt
            np.cumsum(off, out=off)
            self.dense_off = off
            dc = np.zeros(size, np.uint16)
            dc[uniq] = np.minimum(np.where(cnt > self.max_occ, 0, cnt),
                                  0xFFFF)
            self.dense_cnt = dc

    def ranges(self, q_codes: np.ndarray):
        """(lo, hi) index ranges for each query k-mer code (max_occ
        masking NOT applied here — callers mask on hi-lo)."""
        if self.dense_off is not None:
            lo = self.dense_off[q_codes].astype(np.int64)
            hi = self.dense_off[q_codes + 1].astype(np.int64)
            return lo, hi
        lo = np.searchsorted(self.sorted_codes, q_codes, side="left")
        hi = np.searchsorted(self.sorted_codes, q_codes, side="right")
        return lo, hi

    def lookup(self, q_codes: np.ndarray):
        """All (query_pos, global_target_pos) hits for the query's k-mers,
        with high-frequency k-mers masked."""
        lo, hi = self.ranges(q_codes)
        n = hi - lo
        n = np.where(n > self.max_occ, 0, n)
        total = int(n.sum())
        if total == 0:
            return (np.zeros(0, np.int64),) * 2
        # gather ranges [lo_i, lo_i + n_i) for all i
        qpos = np.repeat(np.arange(len(q_codes), dtype=np.int64), n)
        starts = np.repeat(lo, n)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(n) - n, n)
        tpos = self.sorted_pos[starts + within]
        return qpos, tpos


@dataclass
class Candidate:
    tid: int          # target sequence id
    forward: bool     # query strand that matched
    diag: int         # estimated diagonal (t_local - q_pos)
    hits: int         # raw hit count
    score: float      # clamped ranking score


def _finalize_read_candidates(cands, bin_w, max_candidates, alpha, beta,
                              prune: float = 0.0):
    """Dedupe near-diagonal duplicates, apply the alpha/beta clamp, rank.

    ``prune`` drops candidates whose CLAMPED score falls below
    prune * (the read's best clamped score) before extension.  The
    aligner sets prune to delta^2 by default: the emitted-output
    contract only keeps alignments scoring >= delta * the read's best DP
    score, seed hits track DP score roughly linearly for loci that can
    compete, and the squared margin absorbs the hits->score nonlinearity
    of diverged loci (which have disproportionately FEWER hits than
    score).

    Pruning on the CLAMPED score is where the recovered mecat2ref+
    alpha/beta semantics (AlignGraph2 README.md:43-51: candidate
    blocks scored by a k-mer function clamped to [alpha, beta]) act on
    OUTCOMES: the beta cap bounds the bar a dominant repeat family sets
    (beta down -> repeat crowding suppressed), and the alpha floor lifts
    weakly-seeded diverged loci toward that bar (alpha up -> diverged
    recall up) — a plain clip is monotone and could never change a
    top-K ranking on its own.

    All clamp/threshold arithmetic is float32 so this host path and the
    device seeder (parallel/sharded.py _select_read_candidates) agree
    bit-for-bit."""
    if not cands:
        return []
    cands.sort(key=lambda c: -c.hits)
    # near-diagonal dedupe in stable hits-descending order: drop c if a
    # previously-KEPT candidate with the same (tid, strand) lies within
    # bin_w of its diagonal.  A spatial hash on floor(diag / bin_w)
    # makes this O(n): |d1 - d2| <= bin_w implies the hash cells differ
    # by at most 1, so checking cells {-1, 0, +1} is complete — the
    # result is EXACTLY the naive all-pairs scan's (which was O(n^2)
    # with ~1,100 noise candidates/read at ref_seed_k=12 x 50 Mb and
    # dominated the whole read->ref stage).
    kept = []
    by_cell: dict = {}
    for c in cands:
        cell = c.diag // bin_w
        dup = False
        for nb in (cell - 1, cell, cell + 1):
            for d in by_cell.get((c.tid, c.forward, nb), ()):
                if abs(d - c.diag) <= bin_w:
                    dup = True
                    break
            if dup:
                break
        if not dup:
            by_cell.setdefault((c.tid, c.forward, cell), []).append(c.diag)
            kept.append(c)
    # float32 mean/clamp mirroring the device seeder exactly
    n_kept = np.float32(len(kept))
    mean_hits = np.float32(
        np.sum(np.asarray([c.hits for c in kept], np.float32))) / n_kept
    lo = np.float32(alpha) * mean_hits
    hi = np.float32(beta) * mean_hits
    for c in kept:
        c.score = float(np.clip(np.float32(c.hits), lo, hi))
    if prune > 0.0 and kept:
        best_s = np.float32(max(c.score for c in kept))
        floor = np.float32(prune) * best_s
        kept = [c for c in kept if np.float32(c.score) >= floor]
    # clip is monotone, so hits-descending kept order IS score-descending
    kept.sort(key=lambda c: -c.score)
    return kept[:max_candidates]


def _finalize_read_candidates_arrays(tid, fwd, diag, hits, bin_w,
                                     max_candidates, alpha, beta,
                                     prune: float = 0.0):
    """Array fast path of :func:`_finalize_read_candidates` — identical
    output (tests/test_native_seed.py), but operates on the native
    binner's per-read arrays and only materializes the <= K surviving
    Candidate objects (the list path built ~1,100 dataclass objects per
    read at ref_seed_k=12 x 50 Mb before throwing almost all away)."""
    n = len(tid)
    if n == 0:
        return []
    order = np.argsort(-hits, kind="stable")
    t_s = tid[order]
    f_s = fwd[order]
    d_s = diag[order]
    h_s = hits[order]
    keep_idx = []
    by_cell: dict = {}
    for i in range(n):
        d = int(d_s[i])
        key0 = (int(t_s[i]), bool(f_s[i]))
        cell = d // bin_w
        dup = False
        for nb in (cell - 1, cell, cell + 1):
            for dk in by_cell.get((key0, nb), ()):
                if abs(dk - d) <= bin_w:
                    dup = True
                    break
            if dup:
                break
        if not dup:
            by_cell.setdefault((key0, cell), []).append(d)
            keep_idx.append(i)
    ki = np.asarray(keep_idx, np.int64)
    kh = h_s[ki].astype(np.float32)
    # float32 arithmetic identical to the list path (and the device
    # seeder): np.sum over the same float32 values in the same order
    mean_hits = np.float32(np.sum(kh)) / np.float32(len(ki))
    lo = np.float32(alpha) * mean_hits
    hi = np.float32(beta) * mean_hits
    score = np.clip(kh, lo, hi)
    if prune > 0.0 and len(ki):
        sel = score >= np.float32(prune) * np.float32(score.max())
        ki = ki[sel]
        score = score[sel]
    # clip is monotone, so hits-descending order IS score-descending
    out = []
    for j in range(min(len(ki), max_candidates)):
        i = int(ki[j])
        out.append(Candidate(tid=int(t_s[i]), forward=bool(f_s[i]),
                             diag=int(d_s[i]), hits=int(h_s[i]),
                             score=float(score[j])))
    return out


def find_candidates_batch(index: SeedIndex, read_db, ids, *, bin_w: int,
                          max_candidates: int, min_hits: int, alpha: float,
                          beta: float, prune: float = 0.0,
                          chunk_kmers: int = 32_000_000):
    """Vectorized seeding over MANY reads at once.

    One searchsorted over the concatenated k-mers of a whole read chunk
    replaces the per-read loops; candidate bins are found with a single
    np.unique over packed (read, strand, target, diagonal-bin) keys.
    Returns {read_id: [Candidate, ...]}.
    """
    from ..io.seqdb import revcomp_codes
    k = index.k
    out = {int(r): [] for r in ids}
    ids = list(ids)
    pos = 0
    while pos < len(ids):
        # build a chunk of reads bounded by total k-mer count
        chunk = []
        total = 0
        while pos < len(ids) and total < chunk_kmers:
            rid = int(ids[pos])
            n = read_db.size(rid)
            if n >= k:
                chunk.append(rid)
                total += 2 * (n - k + 1)
            pos += 1
        if not chunk:
            continue
        tags = []     # (rid, strand) per kmer stream
        for rid in chunk:
            n = read_db.size(rid)
            tags.append((rid, 1, n - k + 1))
            tags.append((rid, 0, n - k + 1))

        # production path: per-read native binning (enumeration + bin
        # sort + smoothing + median all in C++, per-read buffers — cost
        # independent of chunk size, no chunk-wide hit sort).  The numpy
        # code below is the specification (tests/test_native_seed.py).
        from .native import seed_bin_native
        base_list = [read_db.get_codes(rid) for rid in chunk]
        read_start = np.zeros(len(chunk) + 1, np.int64)
        np.cumsum([len(b) for b in base_list], out=read_start[1:])
        native_bin = seed_bin_native(
            index, np.concatenate(base_list), read_start, bin_w,
            max(min_hits, 1))
        if native_bin is not None:
            nc, b_tid, b_fwd, b_diag, b_hits = native_bin
            off = 0
            for ci, rid in enumerate(chunk):
                m = int(nc[ci])
                out[rid] = _finalize_read_candidates_arrays(
                    b_tid[off:off + m], b_fwd[off:off + m],
                    b_diag[off:off + m], b_hits[off:off + m],
                    bin_w, max_candidates, alpha, beta, prune)
                off += m
            continue

        # hit enumeration: native single-pass path when available
        # (rolling codes + dense-table lookup + expansion in C++), else
        # the numpy specification below — identical hit streams.
        native_hits = None
        if index.dense_cnt is not None:
            from .native import seed_hits_native
            native_hits = seed_hits_native(
                index, np.concatenate(base_list), read_start)
        if native_hits is not None:
            sid32, qpos32, tpos_g = native_hits
            if len(sid32) == 0:
                continue
            sid = sid32.astype(np.int64)
            q_pos_rep = qpos32.astype(np.int64)
        else:
            codes_list = []
            for rid in chunk:
                cf = read_db.get_codes(rid)
                cr = revcomp_codes(cf)
                codes_list.append(kmer_codes_np(cf, k))
                codes_list.append(kmer_codes_np(cr, k))
            q_codes = np.concatenate(codes_list)
            stream_start = np.zeros(len(tags) + 1, np.int64)
            np.cumsum([n for _, _, n in tags], out=stream_start[1:])
            # count lookup, then COMPRESS to hitting k-mers before any
            # expansion — typically <10% of the stream hits
            if index.dense_cnt is not None:
                hit = np.flatnonzero(index.dense_cnt[q_codes])
                if len(hit) == 0:
                    continue
                q_hit = q_codes[hit]
                n_hit = index.dense_cnt[q_hit].astype(np.int64)
                lo_hit = index.dense_off[q_hit].astype(np.int64)
            else:
                lo, hi = index.ranges(q_codes)
                n_h = hi - lo
                np.putmask(n_h, n_h > index.max_occ, 0)
                hit = np.flatnonzero(n_h)
                if len(hit) == 0:
                    continue
                n_hit = n_h[hit]
                lo_hit = lo[hit]
            total_h = int(n_hit.sum())
            rep = np.repeat(hit, n_hit)       # query-kmer index per hit
            csum = np.cumsum(n_hit)
            within = np.arange(total_h, dtype=np.int64) - np.repeat(
                csum - n_hit, n_hit)
            tpos_g = index.sorted_pos[np.repeat(lo_hit, n_hit) + within]
            # recover (stream, in-stream qpos) arithmetically from rep
            sid = np.searchsorted(stream_start, rep, side="right") - 1
            q_pos_rep = rep - stream_start[sid]
        tid = np.searchsorted(index.db.offsets, tpos_g, side="right") - 1
        t_local = tpos_g - index.db.offsets[tid]
        diag = t_local - q_pos_rep
        dbin = np.floor_divide(diag, bin_w)
        # pack (stream, tid, dbin) into one int64 key; dbin in low bits so
        # key+1 is the adjacent diagonal bin (pair smoothing)
        B0 = np.int64(1) << 24
        MAXB = np.int64(1) << 25
        MAXT = np.int64(1) << 20
        key = (sid * MAXT + tid) * MAXB + (dbin + B0)
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        diag_s = diag[order]
        uniq, starts, cnt = np.unique(key_s, return_index=True,
                                      return_counts=True)
        # smoothed count: own + next-adjacent-bin
        nxt = np.searchsorted(uniq, uniq + 1)
        nxt_ok = (nxt < len(uniq)) & (uniq[np.minimum(nxt, len(uniq) - 1)]
                                      == uniq + 1)
        smooth = cnt + np.where(nxt_ok, cnt[np.minimum(nxt, len(uniq) - 1)],
                                0)
        good = np.flatnonzero(smooth >= max(min_hits, 1))
        per_stream: dict = {}
        for g in good:
            members = diag_s[starts[g]:starts[g] + cnt[g]]
            if nxt_ok[g]:
                g2 = nxt[g]
                members = np.concatenate(
                    [members, diag_s[starts[g2]:starts[g2] + cnt[g2]]])
            s = int(uniq[g] // (MAXT * MAXB))
            t = int((uniq[g] // MAXB) % MAXT)
            rid, strand, _ = tags[s]
            per_stream.setdefault((rid, strand), []).append(
                Candidate(tid=t, forward=bool(strand),
                          diag=int(np.median(members)),
                          hits=int(smooth[g]), score=0.0))
        by_read: dict = {}
        for (rid, strand), cands in per_stream.items():
            by_read.setdefault(rid, []).extend(cands)
        for rid, cands in by_read.items():
            out[rid] = _finalize_read_candidates(
                cands, bin_w, max_candidates, alpha, beta, prune)
    return out


def find_candidates(index: SeedIndex, q_codes_fwd: np.ndarray,
                    q_codes_rev: np.ndarray, *, bin_w: int,
                    max_candidates: int, min_hits: int,
                    alpha: float, beta: float,
                    prune: float = 0.0) -> List[Candidate]:
    """Candidate (target, strand, diagonal) triples for one read."""
    rows = []
    for forward, q_codes in ((True, q_codes_fwd), (False, q_codes_rev)):
        if len(q_codes) == 0:
            continue
        qpos, tpos_g = index.lookup(q_codes)
        if len(qpos) == 0:
            continue
        tid = np.searchsorted(index.db.offsets, tpos_g, side="right") - 1
        t_local = tpos_g - index.db.offsets[tid]
        diag = t_local - qpos
        # bin by (tid, diag // bin_w); smooth over adjacent bins by also
        # crediting bin+1 so near-boundary diagonals count together
        dbin = np.floor_divide(diag, bin_w)
        key = tid * (1 << 34) + (dbin + (1 << 32))
        for shift in (0, 1):
            rows.append((forward, key + shift, diag, np.ones_like(key)))
    if not rows:
        return []

    cands: List[Candidate] = []
    for forward in (True, False):
        keys = [r[1] for r in rows if r[0] == forward]
        diags = [r[2] for r in rows if r[0] == forward]
        if not keys:
            continue
        keys = np.concatenate(keys)
        diags = np.concatenate(diags)
        uniq, inv, cnt = np.unique(keys, return_inverse=True,
                                   return_counts=True)
        good = np.flatnonzero(cnt >= max(min_hits, 1))
        if len(good) == 0:
            continue
        # estimated diagonal per bin: median of member diagonals
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(len(uniq)))
        for g in good:
            members = diags[order[bounds[g]:bounds[g] + cnt[g]]]
            med = int(np.median(members))
            tid = int(uniq[g] >> 34)
            cands.append(Candidate(tid=tid, forward=forward, diag=med,
                                   hits=int(cnt[g]), score=0.0))

    # de-duplicate near-diagonal bins, prune, alpha/beta clamp, rank
    return _finalize_read_candidates(cands, bin_w, max_candidates, alpha,
                                     beta, prune)
