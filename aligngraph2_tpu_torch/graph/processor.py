"""Alignment replay -> graph ingest (the reference's PositionProcessor +
Aligner + AlignReference, AlignGraph2 PAGraph/src/tools/position/
PositionProcessor.cpp:78-151 and tools/align/Aligner.{cpp,tcc}).

Copy of ``aligngraph2_tpu/graph/processor.py``.

Pipeline per reference group:
  1. Replay contig->ref alignments into a per-contig-base lookup of
     reference positions (Aligner::simpleAlign), with a (0,0) sentinel for
     unaligned bases (Aligner::addExtraPosition).
  2. Pass 1: replay each read's contig alignments; every matched read base
     joins its contig position with the contig base's reference positions
     into dual flat coordinates (Aligner::parseToCtg).  Sampled insertion
     into the graph, then edge dedup + epsilon position merge.
  3. Pass 2: replay each read's reference alignments into ref-only
     positions (Aligner::parseToRef, with the coverage filter), merge
     again, sort, reset used flags.

Faithfully reproduced reference quirks (documented because they shape
output parity):
  * alignments whose contig interval touches the contig end
    (contigEnd >= contigLen) are skipped (Aligner.tcc:61-64 uses >=).
  * the read->ref coverage filter consults a per-reference coverage array
    that covInfHelper SORTS ascending (Aligner.cpp:85-87), so the "max
    coverage over the aligned interval" is really the (refEnd-1)-th order
    statistic of the whole coverage distribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..align.records import Alignment, AlignmentSet, exact_align_pairs
from ..config import GraphConfig
from ..coords.mapper import PositionMapper
from ..io.seqdb import SeqDatabase, revcomp_codes
from ..ops.kmer import kmer_codes_np
from .pagraph import PAGraph


@dataclass
class GroupSpec:
    """One reference group from pre-processing: the reference sequence and
    the contigs (with orientation) assigned to it (config.txt semantics,
    pre_process.cpp:271-287)."""
    ref_name: str
    contigs: List[Tuple[str, bool]]   # (contig name, forward)


def _by_query(alns: AlignmentSet, query_db: SeqDatabase,
              target_db: SeqDatabase) -> List[List[Alignment]]:
    """Group alignments per query id, score-descending
    (Aligner::mergeAlignInfHelper)."""
    out: List[List[Alignment]] = [[] for _ in range(len(query_db))]
    for a in alns:
        qi = query_db.seq_id(a.query_name)
        if qi >= 0 and target_db.contains(a.ref_name):
            out[qi].append(a)
    for lst in out:
        lst.sort(key=Alignment.sort_key)
    return out


class AlignReferenceCSR:
    """Per-contig-base reference-position lookup in the contig's group
    orientation (replaces AlignReference's vector-of-vector-of-pairs)."""

    def __init__(self, ctg_len: int):
        self.ctg_len = ctg_len
        self.start = None       # (len+1,) CSR offsets
        self.ref_idx = None     # entries: refIdx+1 (0 = sentinel)
        self.ref_pos = None

    def build(self, triples: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]):
        if triples:
            base = np.concatenate([t[0] for t in triples])
            ridx = np.concatenate([t[1] for t in triples])
            rpos = np.concatenate([t[2] for t in triples])
        else:
            base = np.zeros(0, np.int64)
            ridx = np.zeros(0, np.int64)
            rpos = np.zeros(0, np.int64)
        ok = (base >= 0) & (base < self.ctg_len)
        base, ridx, rpos = base[ok], ridx[ok], rpos[ok]
        counts = np.bincount(base, minlength=self.ctg_len)
        # addExtraPosition: bases with no entry get the (0, 0) sentinel
        empty = np.flatnonzero(counts == 0)
        base = np.concatenate([base, empty])
        ridx = np.concatenate([ridx, np.zeros(len(empty), np.int64)])
        rpos = np.concatenate([rpos, np.zeros(len(empty), np.int64)])
        order = np.argsort(base, kind="stable")
        self.ref_idx = ridx[order]
        self.ref_pos = rpos[order]
        counts = np.bincount(base, minlength=self.ctg_len)
        self.start = np.zeros(self.ctg_len + 1, np.int64)
        np.cumsum(counts, out=self.start[1:])


class PositionProcessor:
    def __init__(self, graph: PAGraph, read_db: SeqDatabase,
                 ctg_db: SeqDatabase, ref_db: SeqDatabase,
                 read_to_ctg: AlignmentSet, read_to_ref: AlignmentSet,
                 ctg_to_ref: AlignmentSet, group: GroupSpec,
                 cfg: GraphConfig):
        self.graph = graph
        self.read_db = read_db
        self.ctg_db = ctg_db
        self.ref_db = ref_db
        self.cfg = cfg
        self.group = group
        self.ctg_mapper = PositionMapper.from_db(ctg_db)
        self.ref_mapper = PositionMapper.from_db(ref_db)
        # The graph stores flat coordinates as uint32 (the reference's
        # own DualPos width, KMerAdjNode.hpp:19-23).  The mapper layout
        # spans ~4x total sequence length, so one group must stay under
        # ~1 Gb of contig/ref sequence — same bound as the reference;
        # the per-reference-group splitting is what keeps runs inside it.
        for nm, m in (("contig", self.ctg_mapper), ("ref", self.ref_mapper)):
            if m.extra_start > 0xFFFFFFFF:
                raise ValueError(
                    f"{nm} flat-coordinate space {m.extra_start} exceeds "
                    "uint32 — group too large for the positional graph "
                    "(split into more reference groups)")
        self._r2c = _by_query(read_to_ctg, read_db, ctg_db)
        self._r2r = _by_query(read_to_ref, read_db, ref_db)
        self._c2r = _by_query(ctg_to_ref, ctg_db, ref_db)
        self.group_ref_id = ref_db.seq_id(group.ref_name)
        # contig orientation map: ctg id -> forward flag (group members only)
        self.ctg_forward: Dict[int, bool] = {}
        for name, fwd in group.contigs:
            cid = ctg_db.seq_id(name)
            if cid >= 0:
                self.ctg_forward[cid] = fwd
        self._align_ref: Dict[int, AlignReferenceCSR] = {}
        self._sorted_cov: Dict[int, np.ndarray] = {}
        self.stats: Dict[str, int] = {}

    # ------------- preprocessing -------------

    def pre_process(self) -> None:
        self._build_coverage()
        self._simple_align()

    def _build_coverage(self) -> None:
        """covInfHelper + the ascending sort quirk."""
        for rid in range(len(self.ref_db)):
            self._sorted_cov[rid] = np.zeros(self.ref_db.size(rid), np.int64)
        for a_list in self._r2r:
            for a in a_list:
                rid = self.ref_db.seq_id(a.ref_name)
                cov = self._sorted_cov[rid]
                end = min(a.re, len(cov))
                if a.rb < end:
                    cov[a.rb:end] += 1
        for rid in self._sorted_cov:
            self._sorted_cov[rid] = np.sort(self._sorted_cov[rid])

    def _simple_align(self) -> None:
        """Aligner::simpleAlign + addExtraPosition."""
        for cid, fwd_c in self.ctg_forward.items():
            clen = self.ctg_db.size(cid)
            ar = AlignReferenceCSR(clen)
            triples = []
            for a in self._c2r[cid]:
                rid = self.ref_db.seq_id(a.ref_name)
                if rid != self.group_ref_id:
                    continue
                if a.forward != fwd_c:
                    continue
                cb, ce = a.qb, a.qe
                if not a.forward:
                    cb, ce = clen - a.qe, clen - a.qb
                ctg_pos, ref_pos = exact_align_pairs(cb, a.rb, True,
                                                     a.qdiff, a.rdiff)
                triples.append((ctg_pos,
                                np.full(len(ctg_pos), rid + 1, np.int64),
                                ref_pos))
            ar.build(triples)
            self._align_ref[cid] = ar

    # ------------- main processing -------------

    def process(self, log=print, threads: int = 0,
                use_native: bool = True) -> None:
        import time
        g = self.graph
        cfg = self.cfg
        t0 = time.perf_counter()
        if not (use_native and self._native_pass(False, threads)):
            self._run_pass(self._emit_read_to_ctg)
        t1 = time.perf_counter()
        self.stats["merge_edge_1"] = g.merge_edges()
        self.stats["total_pos_1"] = g.total_positions()
        self.stats["merge_pos_1"] = g.merge_positions(cfg.epsilon)
        t2 = time.perf_counter()
        log(f"  [pass1] merged edges={self.stats['merge_edge_1']} "
            f"pos={self.stats['total_pos_1']} "
            f"merged pos={self.stats['merge_pos_1']} "
            f"(ingest {t1 - t0:.1f}s merge {t2 - t1:.1f}s)")
        if not (use_native and self._native_pass(True, threads)):
            self._run_pass(self._emit_read_to_ref)
        t3 = time.perf_counter()
        self.stats["merge_edge_2"] = g.merge_edges()
        self.stats["total_pos_2"] = g.total_positions()
        self.stats["merge_pos_2"] = g.merge_positions(cfg.epsilon)
        t4 = time.perf_counter()
        log(f"  [pass2] merged edges={self.stats['merge_edge_2']} "
            f"pos={self.stats['total_pos_2']} "
            f"merged pos={self.stats['merge_pos_2']} "
            f"(ingest {t3 - t2:.1f}s merge {t4 - t3:.1f}s)")
        self.stats["ingest_s"] = round(t1 - t0 + t3 - t2, 2)
        self.stats["merge_s"] = round(t2 - t1 + t4 - t3, 2)
        g.finalize()

    def _native_pass(self, pass2: bool, threads: int) -> bool:
        """Threaded C++ ingest core (native/ingest.cpp); the Python pass
        below is its specification and fallback."""
        from .ingest_native import ingest_pass
        return ingest_pass(self, pass2, threads)

    def _run_pass(self, emitter) -> None:
        for rid in range(len(self.read_db)):
            buckets = emitter(rid)
            for forward, (rpos, cflat, rflat) in buckets.items():
                if len(rpos) == 0:
                    continue
                self._insert_read(rid, forward, rpos, cflat, rflat)

    def _insert_read(self, rid: int, forward: bool, rpos, cflat, rflat):
        g = self.graph
        codes = self.read_db.get_codes(rid, forward)
        n = len(codes)
        order = np.argsort(rpos, kind="stable")
        rpos, cflat, rflat = rpos[order], cflat[order], rflat[order]
        counts = np.bincount(rpos, minlength=n)
        start = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        has_pos = counts > 0
        kmers = kmer_codes_np(codes, g.k)
        nodes, found = g.node_of_codes(kmers)
        sel = g.sample_sequence(nodes, found, has_pos, self.cfg.outer_sample)
        g.add_positions_and_edges(sel, nodes, start, cflat, rflat)

    # ------------- pass emitters -------------

    def _emit_read_to_ctg(self, rid: int):
        """Aligner::parseToCtg for one read -> {strand: triples}."""
        cfg = self.cfg
        read_len = self.read_db.size(rid)
        out = {True: [], False: []}
        top_k = cfg.read_to_ctg_top_k
        cnt = 0
        for a in self._r2c[rid]:
            if 0 <= top_k <= cnt:
                break
            cid = self.ctg_db.seq_id(a.ref_name)
            if cid not in self.ctg_forward:
                continue
            if (a.qe - a.qb) / max(read_len, 1) < cfg.read_to_ctg_ratio:
                continue
            clen = self.ctg_db.size(cid)
            # reference skips contigEnd >= contigLen (Aligner.tcc:61-64)
            if a.re >= clen or a.rb >= clen:
                continue
            fwd_c = self.ctg_forward[cid]
            if fwd_c:
                strand = a.forward
                q0 = a.qb if a.forward else read_len - a.qe
                c0 = a.rb
                read_pos, ctg_pos = exact_align_pairs(q0, c0, True,
                                                      a.qdiff, a.rdiff)
            else:
                strand = not a.forward
                q0 = read_len - a.qe if a.forward else a.qb
                c0 = clen - a.re
                read_pos, ctg_pos = exact_align_pairs(q0, c0, False,
                                                      a.qdiff, a.rdiff)
            ok = (read_pos >= 0) & (read_pos < read_len) \
                & (ctg_pos >= 0) & (ctg_pos < clen)
            read_pos, ctg_pos = read_pos[ok], ctg_pos[ok]
            if len(read_pos) == 0:
                cnt += 1
                continue
            ar = self._align_ref[cid]
            n_ent = ar.start[ctg_pos + 1] - ar.start[ctg_pos]
            rep_read = np.repeat(read_pos, n_ent)
            rep_ctg = np.repeat(ctg_pos, n_ent)
            gather = (np.repeat(ar.start[ctg_pos], n_ent)
                      + np.arange(int(n_ent.sum()))
                      - np.repeat(np.cumsum(n_ent) - n_ent, n_ent))
            ridx = ar.ref_idx[gather]
            rpos_ref = ar.ref_pos[gather]
            ctg_signed = (cid + 1) if fwd_c else -(cid + 1)
            cflat = self.ctg_mapper.dual_to_single(
                np.full(len(rep_ctg), ctg_signed), rep_ctg)
            rflat = self.ref_mapper.dual_to_single(ridx, rpos_ref)
            out[strand].append((rep_read, cflat, rflat))
            cnt += 1
        return {s: _concat3(v) for s, v in out.items()}

    def _emit_read_to_ref(self, rid: int):
        """Aligner::parseToRef for one read -> {strand: triples}."""
        cfg = self.cfg
        read_len = self.read_db.size(rid)
        out = {True: [], False: []}
        top_k = cfg.read_to_ref_top_k
        cnt = 0
        for a in self._r2r[rid]:
            if 0 <= top_k <= cnt:
                break
            rid_ref = self.ref_db.seq_id(a.ref_name)
            if rid_ref != self.group_ref_id:
                continue
            if (a.qe - a.qb) / max(read_len, 1) < cfg.read_to_ref_ratio:
                continue
            # coverage filter over the sorted coverage array (quirk above)
            cov = self._sorted_cov[rid_ref]
            end = min(a.re, len(cov))
            max_cov = int(cov[end - 1]) if a.rb < end else 0
            if max_cov < cfg.cov_filter:
                continue
            strand = a.forward
            q0 = a.qb if a.forward else read_len - a.qe
            read_pos, ref_pos = exact_align_pairs(q0, a.rb, True,
                                                  a.qdiff, a.rdiff)
            ok = (read_pos >= 0) & (read_pos < read_len)
            read_pos, ref_pos = read_pos[ok], ref_pos[ok]
            rflat = self.ref_mapper.dual_to_single(
                np.full(len(ref_pos), rid_ref + 1), ref_pos)
            out[strand].append((read_pos,
                                np.zeros(len(read_pos), np.int64), rflat))
            cnt += 1
        return {s: _concat3(v) for s, v in out.items()}


def _concat3(chunks):
    if not chunks:
        z = np.zeros(0, np.int64)
        return z, z, z
    return (np.concatenate([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
            np.concatenate([c[2] for c in chunks]))
