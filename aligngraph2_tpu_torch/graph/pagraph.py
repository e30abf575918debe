"""Positional A-Bruijn graph as structure-of-arrays.

Re-designs the reference PABruijnGraph/KMerAdjNode
(AlignGraph2 PAGraph/src/tools/graph/PABruijnGraph.{hpp,cpp,tcc},
AlignGraph2 PAGraph/src/tools/node/KMerAdjNode.{hpp,tcc}) from
per-node mutex-guarded vectors into flat arrays + sort/segment reductions.
Copy of ``aligngraph2_tpu/graph/pagraph.py``, except the merge dispatch:
``ALIGNGRAPH2_TPU_TORCH_MERGE`` takes ``native`` (the default) or ``numpy``;
the device merge and its link probe come with a later slice.

  * nodes: the sorted unique solid k-mer codes; a node id is the rank of
    its code (identical to the reference's dense index,
    PABruijnGraph.cpp:10-45).
  * positions: one (node, ctg_flat, ref_flat) triple stream appended during
    ingest, then sorted by node and epsilon-clustered with segment ops.
  * edges: one (from, to, step) stream, deduplicated exactly
    (PABruijnGraph::mergeEdge uses plain equality).

Determinism note: the reference's per-node position clustering is greedy
first-fit in *thread-racy insertion order* (KMerAdjNode.tcc:72-111), so
its exact cluster set is nondeterministic run to run.  We instead sort
each node's positions by (ctg, ref) and chain-cluster: a new cluster opens
where a position is NOT within epsilon of its predecessor under the
reference's similarity rule (both coords within epsilon, with 0 matching
only 0 — PABruijnGraph.cpp:259-274).  The cluster representative is its
first (minimum) member, counts are summed and saturate at uint16 like the
reference's CountType.
"""

from __future__ import annotations

from enum import IntEnum
from typing import Tuple

import numpy as np

U32 = np.uint64  # similarity math widens uint32 coordinates to uint64
MASK32 = np.uint64(0xFFFFFFFF)


class Grade(IntEnum):
    """MatchGrade (PABruijnGraph.hpp:40)."""
    Oops = 0
    Skip = 1
    Good = 2
    Excellent = 3
    Amazing = 4


def _wrap32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.uint64) & MASK32


def is_pos_similar(l_ctg, l_ref, r_ctg, r_ref, deviation):
    """Vectorized PABruijnGraph::isPosSimilar (PABruijnGraph.cpp:379-385):
    per axis, both nonzero and |difference| <= deviation."""
    d_ctg = np.abs(l_ctg.astype(np.int64) - r_ctg.astype(np.int64))
    d_ref = np.abs(l_ref.astype(np.int64) - r_ref.astype(np.int64))
    s1 = (l_ctg != 0) & (r_ctg != 0) & (d_ctg <= deviation)
    s2 = (l_ref != 0) & (r_ref != 0) & (d_ref <= deviation)
    return s1, s2


def is_edge_similar(l_ctg, l_ref, r_ctg, r_ref, dist, deviation, error_rate):
    """Vectorized PABruijnGraph::isEdgeSimilar (PABruijnGraph.cpp:387-400).

    Replicates the reference's uint32 arithmetic: the advance
    ``rhs - lhs`` wraps as uint32, so a negative advance fails the ratio
    test by becoming astronomically large.
    """
    l_ctg = np.asarray(l_ctg, dtype=np.uint64)
    l_ref = np.asarray(l_ref, dtype=np.uint64)
    r_ctg = np.asarray(r_ctg, dtype=np.uint64)
    r_ref = np.asarray(r_ref, dtype=np.uint64)
    dist = np.asarray(dist, dtype=np.int64)
    tmp_ctg = np.where(l_ctg != 0, _wrap32(l_ctg + dist.astype(np.uint64)), 0)
    tmp_ref = np.where(l_ref != 0, _wrap32(l_ref + dist.astype(np.uint64)), 0)
    s1, s2 = is_pos_similar(tmp_ctg, tmp_ref, r_ctg, r_ref, deviation)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio_ctg = np.abs(1.0 - _wrap32(r_ctg - l_ctg).astype(np.float64)
                           / dist)
        ratio_ref = np.abs(1.0 - _wrap32(r_ref - l_ref).astype(np.float64)
                           / dist)
    s1 = s1 | ((l_ctg != 0) & (r_ctg != 0) & (ratio_ctg <= error_rate))
    s2 = s2 | ((l_ref != 0) & (r_ref != 0) & (ratio_ref <= error_rate))
    return s1, s2


def check_position(p1_ctg, p1_ref, p2_ctg, p2_ref, dist, deviation,
                   error_rate) -> np.ndarray:
    """Vectorized PABruijnGraph::checkPosition (PABruijnGraph.cpp:143-165)
    -> Grade array.

    Note the reference computes the unguarded ratio terms even when a
    coordinate is 0 (the uint32 wrap makes them fail for pos2 < pos1);
    we reproduce that exactly.
    """
    p1_ctg = np.asarray(p1_ctg, dtype=np.uint64)
    p1_ref = np.asarray(p1_ref, dtype=np.uint64)
    p2_ctg = np.asarray(p2_ctg, dtype=np.uint64)
    p2_ref = np.asarray(p2_ref, dtype=np.uint64)
    dist = np.asarray(dist, dtype=np.int64)
    s1, s2 = is_edge_similar(p1_ctg, p1_ref, p2_ctg, p2_ref, dist,
                             deviation, error_rate)
    with np.errstate(divide="ignore", invalid="ignore"):
        r1 = np.abs(1.0 - _wrap32(p2_ctg - p1_ctg).astype(np.float64) / dist)
        r2 = np.abs(1.0 - _wrap32(p2_ref - p1_ref).astype(np.float64) / dist)
    s1 = s1 | (r1 <= error_rate)
    s2 = s2 | (r2 <= error_rate)

    out = np.full(np.broadcast(p1_ctg, p2_ctg).shape, Grade.Oops,
                  dtype=np.int8)
    ctg_zero = (p1_ctg == 0) | (p2_ctg == 0)
    ref_zero = (p1_ref == 0) | (p2_ref == 0)

    # branch 1: a ctg coordinate is 0
    b1 = ctg_zero
    b1_val = np.where(
        s2,
        np.where(p2_ctg != 0, Grade.Excellent,
                 np.where(p1_ctg != 0, Grade.Skip, Grade.Good)),
        Grade.Oops)
    # branch 2: ctg coords present, a ref coordinate is 0
    b2 = ~ctg_zero & ref_zero
    b2_val = np.where(s1, np.where(p2_ref != 0, Grade.Excellent, Grade.Good),
                      Grade.Oops)
    # branch 3: all coords present
    b3_val = np.where(s1 & s2, Grade.Amazing,
                      np.where(s1, Grade.Excellent,
                               np.where(s2, Grade.Skip, Grade.Oops)))
    out = np.where(b1, b1_val, np.where(b2, b2_val, b3_val)).astype(np.int8)
    return out


def _append3(buf, n, a, b, c, dtypes=(np.int64, np.int64, np.int64)):
    """Append three equal-length streams to a doubling SoA buffer (one
    array per column, each with its own storage dtype)."""
    m = len(a)
    if buf is None:
        cap = max(4096, 2 * m)
        buf = [np.empty(cap, dt) for dt in dtypes]
    elif n + m > len(buf[0]):
        cap = max(2 * len(buf[0]), n + m)
        nbuf = [np.empty(cap, col.dtype) for col in buf]
        for col, ncol in zip(buf, nbuf):
            ncol[:n] = col[:n]
        buf = nbuf
    buf[0][n:n + m] = a
    buf[1][n:n + m] = b
    buf[2][n:n + m] = c
    return buf, n + m


class PAGraph:
    """The graph: node table + position/edge SoA with CSR views."""

    def __init__(self, solid_codes: np.ndarray, k: int):
        self.k = int(k)
        self.node_codes = np.unique(np.asarray(solid_codes, dtype=np.int64))
        self.n_nodes = len(self.node_codes)
        # dense code -> node-id table (same trick as the seeding index):
        # one gather instead of a binary search over n_nodes codes.  4^k
        # int32 = 1 GB at the default k=14 (4 GB at the max k=15) — the
        # same dense-table scale the reference's kmer_counter allocates
        # (kmer_counter.cpp:21-40), and the binary-search fallback costs
        # ~15 ms/read at genome scale (measured: 88% of the whole graph
        # ingest), so the table pays for itself immediately.
        self._node_table = None
        if self.k <= 15 and self.n_nodes:
            table = np.full(1 << (2 * self.k), -1, np.int32)
            table[self.node_codes] = np.arange(self.n_nodes, dtype=np.int32)
            self._node_table = table
        self.reset()

    # ---------------- ingest ----------------

    # Storage dtypes — the reference's own widths (KMerAdjNode.hpp:19-23:
    # uint32 DualPos coordinates, uint16 CountType): node ids fit int32
    # (<= 4^15), flat coordinates fit uint32 (the mapper layout is
    # guarded at ingest, processor.py pre_process), counts saturate at
    # 0xFFFF.  Halves the graph's resident footprint and memory traffic
    # vs the previous int64 streams.
    POS_DTYPES = (np.int32, np.uint32, np.uint32)
    EDGE_DTYPES = (np.int32, np.int32, np.int32)

    def reset(self) -> None:
        """resetAllNodes: drop all positions and edges."""
        # ingest buffers: amortized-doubling SoA appends (the per-read
        # chunk lists they replace caused one giant concatenate per pass)
        self._pos_buf = None    # [node i32, ctg u32, ref u32] columns
        self._pos_n = 0
        self._edge_buf = None   # [from, to, step] int32 columns
        self._edge_n = 0
        self.pos_node = np.zeros(0, np.int32)
        self.pos_ctg = np.zeros(0, np.uint32)
        self.pos_ref = np.zeros(0, np.uint32)
        self.pos_count = np.zeros(0, np.uint16)
        self.pos_start = np.zeros(self.n_nodes + 1, np.int64)
        self.edge_from = np.zeros(0, np.int32)
        self.edge_to = np.zeros(0, np.int32)
        self.edge_step = np.zeros(0, np.int32)
        self.edge_start = np.zeros(self.n_nodes + 1, np.int64)
        self.used = np.zeros(0, bool)
        self._merged = False
        # merge outputs are already in the spec's sorted order (positions
        # by (node, ctg, ref), edges by (from, to, step)); finalize skips
        # the re-sort while these hold
        self._pos_sorted = False
        self._edges_sorted = False

    def node_of_codes(self, codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """codes -> (node ids, found mask).  Ids at unfound slots are
        arbitrary valid indices — callers only consume found ones."""
        if self._node_table is not None:
            idx = self._node_table[codes].astype(np.int64)
            found = idx >= 0
            np.maximum(idx, 0, out=idx)
            return idx, found
        idx = np.searchsorted(self.node_codes, codes)
        idx_c = np.minimum(idx, self.n_nodes - 1) if self.n_nodes else idx
        found = (self.n_nodes > 0) & (self.node_codes[idx_c] == codes) \
            if self.n_nodes else np.zeros(len(codes), bool)
        return idx_c, found

    def sample_sequence(self, kmer_nodes: np.ndarray, kmer_found: np.ndarray,
                        has_pos: np.ndarray, outer_sample: int) -> np.ndarray:
        """Greedy stride sampling of k-mer start positions along a read
        (PABruijnGraph.tcc sampleSequence): eligible positions (solid k-mer
        AND at least one dual position) taken left to right with gaps of at
        least ``outer_sample``.  Returns selected position indices."""
        eligible = np.flatnonzero(kmer_found & has_pos[:len(kmer_found)])
        if len(eligible) == 0:
            return eligible
        from ..ops.native import stride_sample_native
        sel = stride_sample_native(eligible, outer_sample)
        if sel is not None:
            return sel
        out = []
        i = 0
        while i < len(eligible):
            p = int(eligible[i])
            out.append(p)
            i = int(np.searchsorted(eligible, p + outer_sample))
        return np.asarray(out, dtype=np.int64)

    def add_positions_and_edges(self, sel_pos: np.ndarray,
                                kmer_nodes: np.ndarray,
                                base_pos_start: np.ndarray,
                                dual_ctg: np.ndarray,
                                dual_ref: np.ndarray) -> None:
        """Append one read's sampled positions + consecutive-sample edges.

        base_pos_start: CSR (len+1,) over read base -> dual positions
        dual_ctg/dual_ref: the flat dual coordinate streams.
        """
        if len(sel_pos) == 0:
            return
        nodes = kmer_nodes[sel_pos]
        cnt = base_pos_start[sel_pos + 1] - base_pos_start[sel_pos]
        rep_nodes = np.repeat(nodes, cnt)
        gather = (np.repeat(base_pos_start[sel_pos], cnt)
                  + np.arange(int(cnt.sum())) - np.repeat(
                      np.cumsum(cnt) - cnt, cnt))
        self._pos_buf, self._pos_n = _append3(
            self._pos_buf, self._pos_n, rep_nodes, dual_ctg[gather],
            dual_ref[gather], self.POS_DTYPES)
        if len(sel_pos) > 1:
            steps = np.diff(sel_pos)
            self._edge_buf, self._edge_n = _append3(
                self._edge_buf, self._edge_n, nodes[:-1], nodes[1:], steps,
                self.EDGE_DTYPES)

    def append_positions(self, nodes, ctg, ref) -> None:
        """Raw position ingest (tests and custom graphs)."""
        self._pos_buf, self._pos_n = _append3(
            self._pos_buf, self._pos_n, np.asarray(nodes),
            np.asarray(ctg), np.asarray(ref), self.POS_DTYPES)

    def append_edges(self, frm, to, step) -> None:
        """Raw edge ingest (tests and custom graphs)."""
        self._edge_buf, self._edge_n = _append3(
            self._edge_buf, self._edge_n, np.asarray(frm),
            np.asarray(to), np.asarray(step), self.EDGE_DTYPES)

    # ---------------- merge phases ----------------

    def _pos_order(self) -> np.ndarray:
        """Stable (node, ctg, ref) position ordering: native radix sort
        (~6 counting passes) with the numpy lexsort as spec/fallback —
        the lexsort was the dominant merge cost at genome scale."""
        from .ingest_native import lexsort3_native
        order = lexsort3_native(self.pos_node, self.pos_ctg, self.pos_ref)
        if order is None:
            order = np.lexsort((self.pos_ref, self.pos_ctg, self.pos_node))
        return order

    def _flush(self) -> None:
        if self._pos_n:
            self._pos_sorted = False
            buf, n = self._pos_buf, self._pos_n
            self.pos_node = np.concatenate([self.pos_node, buf[0][:n]])
            self.pos_ctg = np.concatenate([self.pos_ctg, buf[1][:n]])
            self.pos_ref = np.concatenate([self.pos_ref, buf[2][:n]])
            self.pos_count = np.concatenate(
                [self.pos_count, np.ones(n, np.uint16)])
            self._pos_buf = None
            self._pos_n = 0
        if self._edge_n:
            self._edges_sorted = False
            buf, n = self._edge_buf, self._edge_n
            self.edge_from = np.concatenate([self.edge_from, buf[0][:n]])
            self.edge_to = np.concatenate([self.edge_to, buf[1][:n]])
            self.edge_step = np.concatenate([self.edge_step, buf[2][:n]])
            self._edge_buf = None
            self._edge_n = 0

    @staticmethod
    def _merge_backend() -> str:
        """Merge dispatch on ALIGNGRAPH2_TPU_TORCH_MERGE: 'native' (the
        default, C++ core) or 'numpy' (the in-file specification).
        'device' (the sort/segment merge on the card) raises until it is
        ported."""
        from ..utils.backend import resolve_backend
        return resolve_backend("ALIGNGRAPH2_TPU_TORCH_MERGE",
                               ("native", "numpy"),
                               "ROADMAP.md §1 item 9, device graph merge")

    def merge_edges(self) -> int:
        """Exact (from, to, step) dedup; returns removed count
        (PABruijnGraph::mergeEdge).

        Fast path: pack (from, to, step) into one int64 key and sort
        once — same (from, to, step)-ascending result order as
        np.unique's row sort, which stays the fallback when the fields
        don't fit 63 bits."""
        self._flush()
        before = len(self.edge_from)
        if before == 0:
            return 0
        backend = self._merge_backend()
        bn = max(int(self.n_nodes).bit_length(), 1)
        max_step = int(self.edge_step.max())
        min_step = int(self.edge_step.min())
        bs = max(max_step.bit_length(), 1)
        if min_step >= 0 and 2 * bn + bs <= 63:
            key = ((self.edge_from.astype(np.int64) << (bn + bs))
                   | (self.edge_to.astype(np.int64) << bs)
                   | self.edge_step.astype(np.int64))
            key.sort()
            boundary = np.empty(before, np.bool_)
            boundary[0] = True
            np.not_equal(key[1:], key[:-1], out=boundary[1:])
            uniq = key[boundary]
            self.edge_from = (uniq >> (bn + bs)).astype(np.int32)
            self.edge_to = ((uniq >> bs)
                            & ((np.int64(1) << bn) - 1)).astype(np.int32)
            self.edge_step = (uniq
                              & ((np.int64(1) << bs) - 1)).astype(np.int32)
        else:
            # beyond the 63-bit packed key (k=14's 82M nodes + long
            # steps land here): fused native radix dedup, then the
            # argsort path, then numpy lexsort.  The previous
            # np.unique(axis=1) fallback was the dominant pagraph merge
            # cost at genome scale (~90 s on the bench's 47M-edge
            # pass-2 dedup).  The native calls are gated on the backend
            # so ALIGNGRAPH2_TPU_TORCH_MERGE=numpy forces the pure spec
            # path here too (merge_positions already honors it).
            order = None
            if backend != "numpy":
                from .ingest_native import (lexsort3_native,
                                            merge_edges_native)
                merged = merge_edges_native(self.edge_from, self.edge_to,
                                            self.edge_step)
                if merged is not None:
                    self.edge_from, self.edge_to, self.edge_step = merged
                    self._edges_sorted = True
                    return before - len(self.edge_from)
                order = lexsort3_native(self.edge_from, self.edge_to,
                                        self.edge_step)
            if order is None:
                order = np.lexsort((self.edge_step, self.edge_to,
                                    self.edge_from))
            ef = self.edge_from[order]
            et = self.edge_to[order]
            es = self.edge_step[order]
            boundary = np.empty(before, np.bool_)
            boundary[0] = True
            np.not_equal(ef[1:], ef[:-1], out=boundary[1:])
            np.logical_or(boundary[1:], et[1:] != et[:-1],
                          out=boundary[1:])
            np.logical_or(boundary[1:], es[1:] != es[:-1],
                          out=boundary[1:])
            self.edge_from = ef[boundary]
            self.edge_to = et[boundary]
            self.edge_step = es[boundary]
        self._edges_sorted = True
        return before - len(self.edge_from)

    def merge_positions(self, epsilon: int) -> int:
        """Epsilon chain-clustering per node; returns removed count
        (PABruijnGraph::mergeKmerPosition; see determinism note above)."""
        self._flush()
        before = len(self.pos_node)
        if before == 0:
            return 0
        backend = self._merge_backend()
        if backend != "numpy":
            # native single-pass merge (bucket by node + per-segment sort
            # + chain-cluster, native/ingest.cpp agp_merge_pos); the numpy
            # path below is the specification and fallback — its 50M-wide
            # gather / similarity temporaries dominated the merge wall at
            # genome scale
            from .ingest_native import merge_positions_native
            merged = merge_positions_native(self.pos_node, self.pos_ctg,
                                            self.pos_ref, self.pos_count,
                                            self.n_nodes, int(epsilon))
            if merged is not None:
                self.pos_node, self.pos_ctg, self.pos_ref, \
                    self.pos_count = merged
                self._pos_sorted = True
                return before - len(self.pos_node)
        order = self._pos_order()
        node = self.pos_node[order]
        ctg = self.pos_ctg[order]
        ref = self.pos_ref[order]
        cnt = self.pos_count[order]
        # cluster boundary where the reference cmp says NOT similar to the
        # previous member: similar iff (ctg similar or both zero) and (ref
        # similar or both zero) — PABruijnGraph.cpp:266-273
        s1, s2 = is_pos_similar(ctg[:-1], ref[:-1], ctg[1:], ref[1:], epsilon)
        sim1 = s1 | ((ctg[:-1] == 0) & (ctg[1:] == 0))
        sim2 = s2 | ((ref[:-1] == 0) & (ref[1:] == 0))
        same_cluster = sim1 & sim2 & (node[:-1] == node[1:])
        boundary = np.concatenate([[True], ~same_cluster])
        cluster_id = np.cumsum(boundary) - 1
        n_clusters = int(cluster_id[-1]) + 1
        firsts = np.flatnonzero(boundary)
        self.pos_node = node[firsts]
        self.pos_ctg = ctg[firsts]
        self.pos_ref = ref[firsts]
        sums = np.bincount(cluster_id, weights=cnt,
                           minlength=n_clusters).astype(np.int64)
        # uint16 CountType cap (KMerAdjNode.hpp:19-23)
        self.pos_count = np.minimum(sums, 0xFFFF).astype(np.uint16)
        self._pos_sorted = True
        return before - n_clusters

    def finalize(self) -> None:
        """sortKmerPosition + resetUsedFlag + build CSR offsets."""
        self._flush()
        if not self._pos_sorted:
            order = self._pos_order()
            self.pos_node = self.pos_node[order]
            self.pos_ctg = self.pos_ctg[order]
            self.pos_ref = self.pos_ref[order]
            self.pos_count = self.pos_count[order]
            self._pos_sorted = True
        self.pos_start = np.zeros(self.n_nodes + 1, np.int64)
        np.cumsum(np.bincount(self.pos_node, minlength=self.n_nodes),
                  out=self.pos_start[1:])
        if not self._edges_sorted:
            e_order = np.lexsort((self.edge_step, self.edge_to,
                                  self.edge_from))
            self.edge_from = self.edge_from[e_order]
            self.edge_to = self.edge_to[e_order]
            self.edge_step = self.edge_step[e_order]
            self._edges_sorted = True
        self.edge_start = np.zeros(self.n_nodes + 1, np.int64)
        np.cumsum(np.bincount(self.edge_from, minlength=self.n_nodes),
                  out=self.edge_start[1:])
        self.used = np.zeros(len(self.pos_node), bool)

    def total_positions(self) -> int:
        self._flush()
        return len(self.pos_node)

    # ---------------- traversal queries ----------------

    def node_positions(self, node: int) -> slice:
        return slice(int(self.pos_start[node]),
                     int(self.pos_start[node + 1]))

    def node_edges(self, node: int) -> slice:
        return slice(int(self.edge_start[node]),
                     int(self.edge_start[node + 1]))

    def successors(self, node: int, pos_idx: int, deviation: int,
                   error_rate: float):
        """All (position-entry index, step) pairs of child nodes whose
        positions grade better than Oops against this node's position
        (PABruijnGraph::searchSuccessors, PABruijnGraph.cpp:167-197).

        Returns (cand_pos_idx (M,), cand_step (M,)) — global indices into
        the position SoA, so callers read pos_ctg/pos_ref/pos_count/used
        directly.
        """
        es = self.node_edges(node)
        if es.start == es.stop:
            return (np.zeros(0, np.int64),) * 2
        p1c = self.pos_ctg[pos_idx]
        p1r = self.pos_ref[pos_idx]
        cand_idx = []
        cand_step = []
        for e in range(es.start, es.stop):
            child = int(self.edge_to[e])
            step = int(self.edge_step[e])
            ps = self.node_positions(child)
            if ps.start == ps.stop:
                continue
            idx = np.arange(ps.start, ps.stop)
            alive = ~self.used[idx]
            if not alive.any():
                continue
            idx = idx[alive]
            grade = check_position(p1c, p1r, self.pos_ctg[idx],
                                   self.pos_ref[idx], step, deviation,
                                   error_rate)
            keep = grade != Grade.Oops
            if keep.any():
                cand_idx.append(idx[keep])
                cand_step.append(np.full(int(keep.sum()), step, np.int64))
        if not cand_idx:
            return (np.zeros(0, np.int64),) * 2
        return np.concatenate(cand_idx), np.concatenate(cand_step)

    def find_all(self, kmer_codes: np.ndarray):
        """(node ids, seq positions) of solid k-mers along a sequence
        (PABruijnGraph::findAll)."""
        nodes, found = self.node_of_codes(kmer_codes)
        pos = np.flatnonzero(found)
        return nodes[pos], pos
