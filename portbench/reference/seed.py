"""K-mer seeding in plain numpy, one read at a time: the host seeding of
the single-device path and the block seeding of the mesh path.

Written from the semantics the port states (``ops/seedextend.py`` for the
host: all occurrences up to ``max_occ``, diagonal bins with the next bin's
hits added, the median diagonal, the near-diagonal dedup and the
alpha/beta clamp in float32; ``parallel/sharded.py`` for the mesh: blocks
of the target, the first ``occ`` occurrences of a k-mer in a block, the
integer mean diagonal, the top T bins a block, the greedy dedup over the
flat table).  Neither the port nor its index is used: each index here is
built from the target's codes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Cand(NamedTuple):
    tid: int          # target sequence
    forward: bool     # read strand that matched
    diag: int         # diagonal estimate (target position - read position)
    hits: int
    score: float      # clamped ranking score


def kmer_codes(codes: np.ndarray, k: int) -> np.ndarray:
    n = len(codes)
    if n < k:
        return np.zeros(0, np.int64)
    c = codes.astype(np.int64)
    out = np.zeros(n - k + 1, np.int64)
    for j in range(k):
        out = (out << 2) | c[j:n - k + 1 + j]
    return out


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


class TargetIndex:
    """Every k-mer of the target's sequences, sorted by code (ties by
    position): (code, sequence, position in the sequence)."""

    def __init__(self, target, k: int):
        self.k = k
        codes, seq, pos = [], [], []
        for i in range(len(target)):
            c = kmer_codes(target.get(i), k)
            codes.append(c)
            seq.append(np.full(len(c), i, np.int32))
            pos.append(np.arange(len(c), dtype=np.int64))
        codes = np.concatenate(codes)
        order = np.argsort(codes, kind="stable")
        self.codes = codes[order]
        self.seq = np.concatenate(seq)[order]
        self.pos = np.concatenate(pos)[order]

    def hits(self, q_codes: np.ndarray, max_occ: int | None = None):
        """(query position, hit index) for every occurrence of each query
        k-mer; with ``max_occ``, k-mers occurring more often are left
        out."""
        lo = np.searchsorted(self.codes, q_codes, side="left")
        n = np.searchsorted(self.codes, q_codes, side="right") - lo
        if max_occ is not None:
            n = np.where(n > max_occ, 0, n)
        qpos = np.repeat(np.arange(len(q_codes), dtype=np.int64), n)
        within = np.arange(int(n.sum()), dtype=np.int64) \
            - np.repeat(np.cumsum(n) - n, n)
        return qpos, np.repeat(lo, n) + within


def _clamp_scores(hits, alpha, beta):
    """float32 mean of the kept hits, scores clipped to [alpha, beta] x
    the mean."""
    h = np.asarray(hits, np.float32)
    mean = np.float32(np.sum(h)) / np.float32(len(h))
    return np.clip(h, np.float32(alpha) * mean, np.float32(beta) * mean)


# ---------------------------------------------------------------------------
# host seeding (single-device path)


def host_candidates(index: TargetIndex, read: np.ndarray, *, bin_w,
                    max_candidates, min_hits, alpha, beta, prune,
                    max_occ=256) -> list:
    """A read's candidates, best first: hits of both strands (forward
    first) binned by (sequence, diagonal // bin_w); a bin with its next
    bin holding at least min_hits is a candidate, its diagonal the median
    of those hits; then near-diagonal dedup, clamp, prune, top
    max_candidates."""
    k = index.k
    if len(read) < k:
        return []
    cands = []
    for forward, strand in ((True, read), (False, revcomp(read))):
        qpos, hit = index.hits(kmer_codes(strand, k), max_occ)
        if not len(hit):
            continue
        tid = index.seq[hit].astype(np.int64)
        diag = index.pos[hit] - qpos
        dbin = np.floor_divide(diag, bin_w)
        order = np.lexsort((dbin, tid))
        tid, dbin, diag = tid[order], dbin[order], diag[order]
        keys = np.stack([tid, dbin], 1)
        uniq, starts, cnt = np.unique(keys, axis=0, return_index=True,
                                      return_counts=True)
        where = {(int(t), int(b)): g for g, (t, b) in enumerate(uniq)}
        for g, (t, b) in enumerate(uniq):
            nxt = where.get((int(t), int(b) + 1))
            members = diag[starts[g]:starts[g] + cnt[g]]
            hits = int(cnt[g])
            if nxt is not None:
                members = np.concatenate(
                    [members, diag[starts[nxt]:starts[nxt] + cnt[nxt]]])
                hits += int(cnt[nxt])
            if hits >= max(min_hits, 1):
                cands.append((int(t), forward, int(np.median(members)),
                              hits))
    if not cands:
        return []
    cands.sort(key=lambda c: -c[3])
    kept = []
    for c in cands:
        if not any(o[0] == c[0] and o[1] == c[1]
                   and abs(o[2] - c[2]) <= bin_w for o in kept):
            kept.append(c)
    score = _clamp_scores([c[3] for c in kept], alpha, beta)
    if prune > 0.0:
        sel = score >= np.float32(prune) * np.float32(score.max())
        kept = [c for c, s in zip(kept, sel) if s]
        score = score[sel]
    return [Cand(t, f, d, h, float(s))
            for (t, f, d, h), s in list(zip(kept, score))[:max_candidates]]


# ---------------------------------------------------------------------------
# block seeding (mesh path)


class Blocks(NamedTuple):
    seq: np.ndarray     # (NB,) sequence of each block
    start: np.ndarray   # (NB,) start in the sequence
    length: np.ndarray  # (NB,)
    block_len: int
    stride: int
    first: np.ndarray   # (n_seqs + 1,) first block of each sequence


def block_len(longest: int, block_size: int, band_width: int) -> int:
    """The mesh path's block length for a target whose longest sequence
    is ``longest``."""
    BL = min(block_size, longest)
    return max((BL + 127) // 128 * 128, 4 * band_width, 256)


def blocks(target, k: int, BL: int) -> Blocks:
    """Overlapping blocks of BL bases at a stride of BL - BL // 4, in
    sequence order; pieces shorter than k are left out."""
    overlap = BL // 4
    stride = max(BL - overlap, 1)
    seq, start, length, first = [], [], [], [0]
    for i in range(len(target)):
        n = target.size(i)
        for s in range(0, max(n - overlap, 1), stride):
            ln = min(BL, n - s)
            if ln < k:
                continue
            seq.append(i)
            start.append(s)
            length.append(ln)
        first.append(len(seq))
    return Blocks(np.asarray(seq, np.int64), np.asarray(start, np.int64),
                  np.asarray(length, np.int64), BL, stride,
                  np.asarray(first, np.int64))


def _block_hits(index: TargetIndex, blk: Blocks, q_codes, occ, max_occ):
    """(query position, block, position in the block) of the first
    ``occ`` occurrences of each query k-mer in each block, for the blocks
    holding it at most ``max_occ`` times."""
    k = index.k
    qpos, hit = index.hits(q_codes)
    if not len(hit):
        return (np.zeros(0, np.int64),) * 3
    seq = index.seq[hit].astype(np.int64)
    pos = index.pos[hit]
    # a sequence's block b starts at b * stride; it holds the k-mer at pos
    # iff start <= pos <= start + length - k
    lo_b = np.maximum(-(-(pos - (blk.block_len - k)) // blk.stride), 0)
    hi_b = pos // blk.stride
    q_out, b_out, p_out = [], [], []
    for off in range(-(-blk.block_len // blk.stride) + 1):
        b_local = lo_b + off
        b = blk.first[seq] + b_local
        ok = (b_local <= hi_b) & (b < blk.first[seq + 1])
        b = np.where(ok, b, 0)
        inb = pos - blk.start[b]
        ok &= (inb >= 0) & (inb <= blk.length[b] - k)
        q_out.append(qpos[ok])
        b_out.append(b[ok])
        p_out.append(inb[ok])
    q, b, p = (np.concatenate(x) for x in (q_out, b_out, p_out))
    order = np.lexsort((p, b, q))
    q, b, p = q[order], b[order], p[order]
    group = np.concatenate([[True], (q[1:] != q[:-1]) | (b[1:] != b[:-1])])
    gid = np.cumsum(group) - 1
    gstart = np.flatnonzero(group)
    rank = np.arange(len(q)) - gstart[gid]
    size = np.diff(np.append(gstart, len(q)))[gid]
    keep = (rank < occ) & (size <= max_occ)
    return q[keep], b[keep], p[keep]


def mesh_candidates(index: TargetIndex, blk: Blocks, read: np.ndarray, *,
                    NQ, bin_w, K, min_hits, alpha, beta, prune, occ=4,
                    max_occ=256) -> list:
    """A read's selected candidates as (block, forward, block diagonal,
    hits, score), in selection order.  Per (strand, block): a histogram of
    diagonal bins (diagonal + NQ, bins of bin_w) with the next bin's
    count added, the top K bins (count descending, the lower bin first)
    with the integer mean diagonal; then over the flat table (forward
    strand first, blocks ascending) a stable count-descending greedy
    dedup on (sequence, strand) within bin_w of the global diagonal, the
    float32 clamp and prune, and the first K kept."""
    k = index.k
    NB = len(blk.seq)
    nbins = int(np.ceil((blk.block_len + NQ) / bin_w)) + 2
    flat_cnt, flat_diag = [], []
    for strand in (read, revcomp(read)):
        hist = np.zeros((NB, nbins + 1), np.int64)
        dsum = np.zeros((NB, nbins + 1), np.int64)
        if len(strand) >= k:
            q, b, p = _block_hits(index, blk, kmer_codes(strand, k), occ,
                                  max_occ)
            diag = p - q + NQ
            bins = np.clip(diag // bin_w, 0, nbins - 1)
            np.add.at(hist, (b, bins), 1)
            np.add.at(dsum, (b, bins), diag)
        hist, dsum = hist[:, :nbins], dsum[:, :nbins]
        sm_h = hist.copy()
        sm_h[:, :-1] += hist[:, 1:]
        sm_d = dsum.copy()
        sm_d[:, :-1] += dsum[:, 1:]
        # top K bins a block: count descending, the lower bin first
        top = np.argsort(-sm_h, axis=1, kind="stable")[:, :K]
        cnt = np.take_along_axis(sm_h, top, 1)
        d = np.take_along_axis(sm_d, top, 1)
        flat_cnt.append(cnt)
        flat_diag.append(np.where(cnt > 0, d // np.maximum(cnt, 1) - NQ, 0))
    cnt = np.concatenate([c.reshape(-1) for c in flat_cnt])
    diag = np.concatenate([d.reshape(-1) for d in flat_diag])
    block = np.tile(np.repeat(np.arange(NB), K), 2)
    forward = np.repeat([True, False], NB * K)
    seq = blk.seq[block]
    gdiag = blk.start[block] + diag
    kept = []
    for i in np.argsort(-cnt, kind="stable"):
        if cnt[i] < min_hits:
            break
        if not any(seq[j] == seq[i] and forward[j] == forward[i]
                   and abs(int(gdiag[j]) - int(gdiag[i])) <= bin_w
                   for j in kept):
            kept.append(int(i))
    if not kept:
        return []
    score = _clamp_scores(cnt[kept], alpha, beta)
    if prune > 0.0:
        sel = score >= np.float32(prune) * np.float32(score.max())
        kept = [i for i, s in zip(kept, sel) if s]
        score = score[sel]
    return [(int(block[i]), bool(forward[i]), int(diag[i]), int(cnt[i]),
             float(s)) for i, s in list(zip(kept, score))[:K]]
