"""The plain reference of one aligner job, read by read: seeding, the band,
the traceback, the gapped strings, the record filters, the duplicate and
delta filters, and the 3-line ``.ref`` text of each record.

It follows the records the port's ``LongReadAligner.align_reads`` states
for its two paths:

  * single-device: host seeding, the static band (W = max(band_width,
    256), the seed diagonal at column W/2 of a standard-frame window) for
    reads up to the 65536 bucket, the adaptive band past it;
  * mesh: block seeding and the adaptive band on every lane.

Records of one read depend on that read alone (a read's candidates are
emitted together, at most ``max_candidates`` of them, and the duplicate
filter looks back 8 records), so a sample of reads checks a job.  Imports
nothing of the port and takes nothing it made.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import band, seed

STATIC_MAX_NQ = 65536
Q_SENTINEL, T_SENTINEL = 254, 255
DUP_WINDOW = 8


def bucket(n: int) -> int:
    """The length bucket a read of n bases is padded to."""
    for b in (512, 2048, 8192, 10240, 12288, 16384, 32768):
        if n <= b:
            return b
    b = 32768
    while b < n:
        b <<= 1
    return b


def effective_k(cfg: dict, target_total: int) -> int:
    """seed_k, grown while the target's random-hit rate G / 4^k is above
    seed_noise_rate when seed_k_auto is on."""
    k = cfg["seed_k"]
    if not cfg["seed_k_auto"]:
        return k
    k_max = max(k, cfg["seed_k_max"])
    while k < k_max and target_total > cfg["seed_noise_rate"] * 4 ** k:
        k += 1
    return k


def moves_to_strings(moves_rev, q_codes, start_q, start_t, t_codes):
    """Gapped strings from END->START moves: (qstr, tstr, qe, te)."""
    moves = moves_rev[moves_rev != 0][::-1]
    q_adv = moves != band.LEFT
    t_adv = moves != band.UP
    qi = start_q + np.cumsum(q_adv) - q_adv
    ti = start_t + np.cumsum(t_adv) - t_adv
    qs = np.where(q_adv, q_codes[np.minimum(qi, len(q_codes) - 1)], 4)
    ts = np.where(t_adv, t_codes[np.minimum(ti, len(t_codes) - 1)], 4)
    table = np.frombuffer(b"ACGT-", np.uint8)
    return (table[qs].tobytes().decode(), table[ts].tobytes().decode(),
            int(start_q + q_adv.sum()), int(start_t + t_adv.sum()))


class Lane:
    """One (read, candidate) extension and what its record needs."""

    def __init__(self, read, tid, forward, codes):
        self.read, self.tid, self.forward, self.codes = \
            read, tid, forward, codes
        self.out = None   # (score, qstr, tstr, qb, qe, rb, re) or None


def _static_lanes(lanes, NQ, W, target, cfg, dev, cap):
    """Static band of W cells on lanes whose buckets are at most NQ:
    fills lane.out."""
    B = len(lanes)
    q = np.full((B, NQ), Q_SENTINEL, np.uint8)
    t = np.full((B, NQ + W), T_SENTINEL, np.uint8)
    qlen = np.zeros(B, np.int32)
    starts = np.zeros(B, np.int64)
    for b, ln in enumerate(lanes):
        q[b, :len(ln.codes)] = ln.codes
        qlen[b] = len(ln.codes)
        tc = target.get(ln.tid)
        ws = ln.diag - W // 2
        starts[b] = ws
        lo, hi = max(0, ws), min(len(tc), ws + NQ + W)
        if hi > lo:
            t[b, lo - ws:hi - ws] = tc[lo:hi]
    score, bi, bj, words, _ = band.static_dp(
        *(torch.from_numpy(x).to(dev) for x in (q, t, qlen)), W=W,
        match=cfg["match_score"], mismatch=cfg["mismatch_score"],
        gap=cfg["gap_score"], x_drop=cfg["x_drop"], cap=cap)
    moves, si, sj = band.static_traceback(words, bi, bj,
                                          max_steps=2 * NQ + W)
    score, moves, si, sj = (x.cpu().numpy() for x in (score, moves, si, sj))
    for b, ln in enumerate(lanes):
        if score[b] <= 0:
            continue
        qb, tb = int(si[b]), int(si[b] + sj[b])
        qstr, tstr, qe, te = moves_to_strings(moves[b], ln.codes, qb, tb,
                                              np.minimum(t[b], 3))
        rb, re = int(starts[b] + tb), int(starts[b] + te)
        if rb < 0 or re > target.size(ln.tid):
            continue
        ln.out = (int(score[b]), qstr, tstr, qb, qe, rb, re)


def _adaptive_lanes(lanes, NQ, W, target, cfg, dev, cap):
    """Adaptive band of W cells on lanes whose buckets are at most NQ
    (lane.ws: the window's start in the sequence, lane.c0: the first
    centre); each lane's window is its own bucket + 2W long, as the
    program forms it: fills lane.out."""
    NT = NQ + 2 * W
    B = len(lanes)
    q = np.zeros((B, NQ), np.uint8)
    t = np.zeros((B, NT), np.uint8)
    qlen, tlen, c0, nt = (np.zeros(B, np.int32) for _ in range(4))
    wins = []
    for b, ln in enumerate(lanes):
        q[b, :len(ln.codes)] = ln.codes
        qlen[b] = len(ln.codes)
        nt[b] = bucket(len(ln.codes)) + 2 * W
        win = target.get(ln.tid)[ln.ws:ln.ws + nt[b]]
        wins.append(win)
        t[b, :len(win)] = win
        tlen[b] = len(win)
        c0[b] = ln.c0
    score, bi, bj, dirs, centers = band.adaptive_dp(
        *(torch.from_numpy(x).to(dev) for x in (q, qlen, t, tlen, c0)),
        W=W, match=cfg["match_score"], mismatch=cfg["mismatch_score"],
        gap=cfg["gap_score"], x_drop=cfg["x_drop"], cap=cap,
        nt=torch.from_numpy(nt).to(dev))
    moves, si, sj = band.adaptive_traceback(dirs, centers, bi, bj,
                                            max_steps=NQ + NT)
    tb = band.adaptive_start_column(si, sj, centers, W)
    score, moves, si, tb = (x.cpu().numpy() for x in (score, moves, si, tb))
    for b, ln in enumerate(lanes):
        if score[b] <= 0:
            continue
        qstr, tstr, qe, te = moves_to_strings(moves[b], ln.codes,
                                              int(si[b]), int(tb[b]),
                                              wins[b])
        ln.out = (int(score[b]), qstr, tstr, int(si[b]), qe,
                  ln.ws + int(tb[b]), ln.ws + te)


def _run_lanes(lanes, run, W, target, cfg, dev, cap, times, per_call=64):
    """Lanes through ``run`` in calls of up to ``per_call``.  With x_drop a
    lane stops by its own length, and no result depends on the call's
    padded length past the lane's bucket, so the lanes go shortest first
    whatever their bucket (the band costs a call its longest lane's
    rows); without it a call takes one bucket, as the program's do."""
    if cfg["x_drop"] > 0:
        lanes = sorted(lanes, key=lambda ln: len(ln.codes))
        calls = [lanes[s:s + per_call]
                 for s in range(0, len(lanes), per_call)]
    else:
        by_nq = {}
        for ln in lanes:
            by_nq.setdefault(bucket(len(ln.codes)), []).append(ln)
        calls = [g[s:s + per_call] for _, g in sorted(by_nq.items())
                 for s in range(0, len(g), per_call)]
    for call in calls:
        NQ = max(bucket(len(ln.codes)) for ln in call)
        t0 = time.perf_counter()
        run(call, NQ, W, target, cfg, dev, cap)
        times[f"band_{NQ}"] = times.get(f"band_{NQ}", 0.0) \
            + time.perf_counter() - t0


def records_text(read_name, lanes, target, cfg) -> list:
    """The read's records, as ``align_reads`` returns them: length and
    identity filters, the duplicate filter, the delta filter, score
    descending (stable); each as its 3-line text."""
    recs = []
    best = 0
    for ln in lanes:
        if ln.out is None:
            continue
        score, qstr, tstr, qb, qe, rb, re = ln.out
        if qe - qb < cfg["min_aln_len"]:
            continue
        qa = np.frombuffer(qstr.encode(), np.uint8)
        ta = np.frombuffer(tstr.encode(), np.uint8)
        if int(np.count_nonzero(qa == ta)) < cfg["min_identity"] * len(qstr):
            continue
        n = len(ln.codes)
        qb_f, qe_f = (qb, qe) if ln.forward else (n - qe, n - qb)
        if any(o[1] == ln.tid and o[2] == ln.forward
               and min(o[6], re) - max(o[5], rb) > 0.5 * (re - rb)
               for o in recs[-DUP_WINDOW:]):
            continue
        recs.append((score, ln.tid, ln.forward, qb_f, qe_f, rb, re, n,
                     qstr, tstr))
        best = max(best, score)
    kept = [r for r in recs if r[0] >= cfg["delta"] * best]
    kept.sort(key=lambda r: -r[0])
    return [f"{read_name}\t{target.names[tid]}\t{'F' if fw else 'R'}\t"
            f"{score}\t{qb}\t{qe}\t{n}\t{rb}\t{re}\t{target.size(tid)}\n"
            f"{qstr}\n{tstr}\n"
            for score, tid, fw, qb, qe, rb, re, n, qstr, tstr in kept]


class Reference:
    """The reference aligner over a target, for one path ("single" or
    "mesh") and one aligner configuration (every field of the port's
    AlignerConfig, as a dict)."""

    def __init__(self, target, cfg: dict, path: str, device="cpu",
                 cap=None, band_shift=0):
        self.target, self.cfg, self.path = target, cfg, path
        self.dev = torch.device(device)
        self.cap = cap
        # the band's cells, W >> band_shift (the control's narrower band)
        self.static_w = max(cfg["band_width"], 256) >> band_shift
        self.adaptive_w = cfg["band_width"] >> band_shift
        t0 = time.perf_counter()
        k = effective_k(cfg, int(target.lengths.sum()))
        self.index = seed.TargetIndex(target, k)
        if path == "mesh":
            BL = seed.block_len(int(target.lengths.max()), cfg["block_size"],
                                cfg["band_width"])
            self.blocks = seed.blocks(target, k, BL)
        # seconds by phase: the index, the seeding, the band a bucket
        self.times = {"index": time.perf_counter() - t0}

    def _lanes_single(self, rid, read):
        cfg = self.cfg
        W = self.adaptive_w
        cands = seed.host_candidates(
            self.index, read, bin_w=max(cfg["band_width"] // 2, 32),
            max_candidates=cfg["max_candidates"],
            min_hits=cfg["min_block_hits"], alpha=cfg["alpha"],
            beta=cfg["beta"], prune=prune_ratio(cfg))
        lanes = []
        for c in cands:
            ln = Lane(rid, c.tid, c.forward,
                      read if c.forward else seed.revcomp(read))
            ln.diag = c.diag
            ln.ws = max(0, c.diag - W)
            ln.c0 = c.diag - ln.ws
            lanes.append(ln)
        return lanes

    def _lanes_mesh(self, rid, read):
        cfg = self.cfg
        W = self.adaptive_w
        NQ = bucket(len(read))
        NT = NQ + 2 * W
        blk = self.blocks
        lanes = []
        for b, forward, diag, _, _ in seed.mesh_candidates(
                self.index, blk, read, NQ=NQ,
                bin_w=max(cfg["band_width"] // 2, 32),
                K=cfg["max_candidates"], min_hits=cfg["min_block_hits"],
                alpha=cfg["alpha"], beta=cfg["beta"],
                prune=prune_ratio(cfg)):
            tid, bstart = int(blk.seq[b]), int(blk.start[b])
            ws = max(0, diag - W)
            if min(self.target.size(tid) - (bstart + ws), NT) <= 0:
                continue
            ln = Lane(rid, tid, forward,
                      read if forward else seed.revcomp(read))
            ln.ws = bstart + ws
            ln.c0 = diag - ws
            lanes.append(ln)
        return lanes

    def align(self, reads, rids) -> dict:
        """{read id: [record text, ...]} for the given reads (reads longer
        than max_read_len have none)."""
        cfg = self.cfg
        per_read = {}
        t0 = time.perf_counter()
        for rid in rids:
            codes = reads.get(rid)
            if len(codes) > cfg["max_read_len"]:
                per_read[rid] = []
                continue
            per_read[rid] = (self._lanes_mesh(rid, codes)
                             if self.path == "mesh"
                             else self._lanes_single(rid, codes))
        self.times["seed"] = time.perf_counter() - t0
        lanes = [ln for ls in per_read.values() for ln in ls]
        run = (self.target, cfg, self.dev, self.cap, self.times)
        if self.path == "mesh":
            _run_lanes(lanes, _adaptive_lanes, self.adaptive_w, *run)
        else:
            _run_lanes([ln for ln in lanes
                        if bucket(len(ln.codes)) <= STATIC_MAX_NQ],
                       _static_lanes, self.static_w, *run)
            _run_lanes([ln for ln in lanes
                        if bucket(len(ln.codes)) > STATIC_MAX_NQ],
                       _adaptive_lanes, self.adaptive_w, *run)
        return {rid: records_text(reads.names[rid], ls, self.target, cfg)
                for rid, ls in per_read.items()}


def prune_ratio(cfg: dict) -> float:
    """candidate_prune, or delta^2 when it is negative (auto)."""
    p = cfg["candidate_prune"]
    return p if p >= 0 else cfg["delta"] ** 2
