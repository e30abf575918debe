"""Reduced-graph POA consensus — the specification of the device
consensus path.

Copy of ``aligngraph2_tpu/consensus/reduced.py``.

The reference builds its POA graph one alignment column at a time
(AlignGraph2 PAGraph/src/tools/cns/AlnGraphBoost.cpp:64-113): every
inserted base becomes a fresh graph node, and ``mergeNodes``
(:137-275) then collapses identical single-in/single-out runs.  That is
O(total alignment columns) of pointer surgery — the opposite of an
accelerator workload.

Key observation: the *merged* graph is tiny, and everything the merge
needs is computable by batched aggregation over (alignment, column)
tensors:

  * backbone node weight / coverage        -> segment sums keyed by
    backbone position,
  * match-to-match ("anchored") edges      -> segment sums keyed by
    (u, v) with a first-touch min for edge-list ordering,
  * runs of inserted bases ("chains")      -> deduplicated by
    (prev anchor, next anchor, bases); identical chains between the same
    anchors provably always fully merge under mergeNodes (suffix merges
    via merge_in_nodes cascade + prefix merges via merge_out_nodes), with
    counts summing and the surviving node indices those of the
    first-created occurrence.

So the pipeline is: aggregate columns (this file: numpy spec;
consensus/device.py: torch ops on the device) -> build the pre-reduced
graph -> run the SAME mergeNodes / bestPath semantics on it
(order-keyed: node creation indices and edge first-touch times stand in
for the sequential build's implicit orderings, which the best-path
strict-'>' tie break depends on).  Output is bit-identical to consensus/poa.py::AlnGraph —
gated by tests/test_consensus_reduced.py fuzz.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .poa import AlnGraph  # noqa: F401  (oracle; used by tests)


class WindowTables:
    """Aggregated build state of one window (the reduced graph inputs)."""

    def __init__(self, skeleton_len: int):
        n = skeleton_len + 2
        self.skeleton_len = skeleton_len
        self.bb_weight = np.zeros(n, np.int64)
        self.bb_cov = np.zeros(n, np.int64)
        # (u, v) -> [count, first_touch]; initial backbone chain edges
        # are ft=-1 so they sort before any alignment-created edge
        self.edges: Dict[Tuple[int, int], List[int]] = {}
        for i in range(skeleton_len + 1):
            self.edges[(i, i + 1)] = [0, -1]
        # (prev_anchor, next_anchor, bases) ->
        #   [weight_sum, creation, ft_head, ft_tail, bbpos_tuple]
        self.chains: Dict[Tuple[int, int, str], List] = {}

    def _edge(self, u: int, v: int, w: int, ft: int) -> None:
        e = self.edges.get((u, v))
        if e is None:
            self.edges[(u, v)] = [w, ft]
        else:
            e[0] += w
            if ft < e[1]:
                e[1] = ft


def extract_window_tables(skeleton_len: int,
                          alns: List[Tuple[int, str, str, int]]
                          ) -> WindowTables:
    """Numpy/python specification of the column aggregation.

    ``alns``: (start, qstr, tstr, weight) per alignment, already sliced
    to the window, gap-normalized, sorted and weighted — i.e. exactly
    what AlnGraph.add_aln would consume, in the same order.
    """
    t = WindowTables(skeleton_len)
    exit_node = skeleton_len + 1
    gcol = 0       # global column counter (times are 2*gcol; exit edges
    creation = 0   # odd) — matches sequential edge creation order
    for start, qstr, tstr, w in alns:
        if w <= 0:
            continue
        bb = start
        prev_node = 0          # ENTER
        prev_is_ins = False
        chain = None           # (prev_anchor, [bases], [bbpos], ft_head,
        #                         creation_of_head)
        for qb, tb in zip(qstr, tstr):
            if qb == tb:
                cur = bb
                t.bb_cov[cur] += w
                t.bb_weight[cur] += w
                if chain is not None:
                    pa, bases, bpos, ft_head, crea = chain
                    _close_chain(t, pa, cur, bases, bpos, ft_head,
                                 2 * gcol, crea, w)
                    chain = None
                else:
                    t._edge(prev_node, cur, w, 2 * gcol)
                bb += 1
                prev_node = cur
                prev_is_ins = False
            elif qb == "-" and tb != "-":
                t.bb_cov[bb] += w
                bb += 1
            elif qb != "-" and tb == "-":
                if chain is None:
                    chain = (prev_node, [qb], [bb], 2 * gcol, creation)
                else:
                    chain[1].append(qb)
                    chain[2].append(bb)
                creation += 1
                prev_is_ins = True
            gcol += 1
        if chain is not None:
            pa, bases, bpos, ft_head, crea = chain
            _close_chain(t, pa, exit_node, bases, bpos, ft_head,
                         2 * gcol - 1, crea, w)
        else:
            t._edge(prev_node, exit_node, w, 2 * gcol - 1)
    return t


def _close_chain(t: WindowTables, prev_anchor: int, next_anchor: int,
                 bases: List[str], bbpos: List[int], ft_head: int,
                 ft_tail: int, creation: int, w: int) -> None:
    key = (prev_anchor, next_anchor, "".join(bases))
    g = t.chains.get(key)
    if g is None:
        t.chains[key] = [w, creation, ft_head, ft_tail, tuple(bbpos)]
    else:
        g[0] += w
        # occurrences arrive in creation order, so the first one holds
        # the min creation index and both min first-touch times
        if creation < g[1]:
            g[1] = creation
            g[2] = ft_head
            g[3] = ft_tail
            g[4] = tuple(bbpos)


# --------------- reduced graph: merge + best path ---------------


class _RGraph:
    """Order-keyed AlnGraph twin built from WindowTables.

    Node order keys reproduce the sequential build's creation indices
    (backbone nodes 0..L+1, then inserts in creation order); edge lists
    are materialized in first-touch order, reproducing the sequential
    build's insertion-ordered adjacency (which mergeNodes' grouping and
    bestPath's strict-'>' tie break observe).
    """

    def __init__(self, skeleton: str, t: WindowTables):
        blen = len(skeleton)
        self.exit = blen + 1
        n = blen + 2
        self.base = ["^"] + list(skeleton) + ["$"]
        self.weight = list(t.bb_weight)
        for i in range(1, blen + 1):
            self.weight[i] += 1
        self.cov = t.bb_cov.copy()          # indexed by backbone position
        self.backbone = [True] * n
        self.bbpos = list(range(n))
        self.deleted = [False] * n
        self.order = list(range(n))
        self.out: List[List[List[int]]] = [[] for _ in range(n)]
        self.in_: List[List[List[int]]] = [[] for _ in range(n)]

        # chain nodes
        chain_head = {}
        chain_nodes = {}
        for key, (w, crea, fth, ftt, bpos) in t.chains.items():
            prev, nxt, bases = key
            ids = []
            for j, b in enumerate(bases):
                nid = len(self.base)
                self.base.append(b)
                self.weight.append(w)
                self.backbone.append(False)
                self.bbpos.append(bpos[j])
                self.deleted.append(False)
                self.order.append(n + crea + j)
                self.out.append([])
                self.in_.append([])
                ids.append(nid)
            chain_head[key] = ids[0]
            chain_nodes[key] = ids

        # edge events: (ft, u, v, count)
        events = [(ft, u, v, c) for (u, v), (c, ft) in t.edges.items()]
        for key, (w, crea, fth, ftt, bpos) in t.chains.items():
            prev, nxt, bases = key
            ids = chain_nodes[key]
            events.append((fth, prev, ids[0], w))
            for a, b in zip(ids, ids[1:]):
                events.append((fth, a, b, w))
            events.append((ftt, ids[-1], nxt, w))
        events.sort(key=lambda e: e[0])
        for ft, u, v, c in events:
            self.out[u].append([v, c])
            self.in_[v].append([u, c])

    # ---- AlnGraph.merge_nodes semantics, order-keyed ----

    def _find(self, es, v):
        for e in es:
            if e[0] == v:
                return e
        return None

    def _reap(self, n):
        self.deleted[n] = True
        for src, _ in self.in_[n]:
            es = self.out[src]
            for i, e in enumerate(es):
                if e[0] == n:
                    del es[i]
                    break
        for tgt, _ in self.out[n]:
            es = self.in_[tgt]
            for i, e in enumerate(es):
                if e[0] == n:
                    del es[i]
                    break
        self.in_[n] = []
        self.out[n] = []

    def _merge_in_nodes(self, n):
        groups: Dict[str, List[int]] = {}
        for src, _ in self.in_[n]:
            if len(self.out[src]) == 1:
                groups.setdefault(self.base[src], []).append(src)
        for nodes in groups.values():
            if len(nodes) <= 1:
                continue
            nodes.sort(key=lambda x: self.order[x])
            an = nodes[0]
            for ni in nodes[1:]:
                c_ni = self.out[ni][0][1]
                tgt = self.out[an][0][0]
                self.out[an][0][1] += c_ni
                self._find(self.in_[tgt], an)[1] += c_ni
                self.weight[an] += self.weight[ni]
            for ni in nodes[1:]:
                for src, cnt in list(self.in_[ni]):
                    e = self._find(self.in_[an], src)
                    if e is None:
                        self.in_[an].append([src, cnt])
                    else:
                        e[1] += cnt
                    e2 = self._find(self.out[src], an)
                    if e2 is None:
                        self.out[src].append([an, cnt])
                    else:
                        e2[1] += cnt
                self._reap(ni)
            self._merge_in_nodes(an)

    def _merge_out_nodes(self, n):
        groups: Dict[str, List[int]] = {}
        for tgt, _ in self.out[n]:
            if len(self.in_[tgt]) == 1:
                groups.setdefault(self.base[tgt], []).append(tgt)
        for nodes in groups.values():
            if len(nodes) <= 1:
                continue
            nodes.sort(key=lambda x: self.order[x])
            an = nodes[0]
            for ni in nodes[1:]:
                c_ni = self.in_[ni][0][1]
                src = self.in_[an][0][0]
                self.in_[an][0][1] += c_ni
                self._find(self.out[src], an)[1] += c_ni
                self.weight[an] += self.weight[ni]
            for ni in nodes[1:]:
                for tgt, cnt in list(self.out[ni]):
                    e = self._find(self.out[an], tgt)
                    if e is None:
                        self.out[an].append([tgt, cnt])
                    else:
                        e[1] += cnt
                    e2 = self._find(self.in_[tgt], an)
                    if e2 is None:
                        self.in_[tgt].append([an, cnt])
                    else:
                        e2[1] += cnt
                self._reap(ni)

    def merge_nodes(self):
        from collections import deque
        visited = set()
        queue = deque([0])
        while queue:
            u = queue.popleft()
            self._merge_in_nodes(u)
            self._merge_out_nodes(u)
            for v, _ in list(self.out[u]):
                visited.add((u, v))
                if all((w, v) in visited for w, _ in self.in_[v]):
                    queue.append(v)

    def best_path(self):
        from collections import deque
        node_score = {self.exit: 0.0}
        best_edge = {}
        visited = set()
        queue = deque([self.exit])
        while queue:
            n = queue.popleft()
            best_found = False
            best_score = -float("inf")
            best_tgt = -1
            for tgt, cnt in self.out[n]:
                score = node_score.get(tgt, 0.0)
                if self.backbone[tgt] and self.weight[tgt] == 1:
                    ns = score - 10.0
                else:
                    ns = cnt - self.cov[self.bbpos[tgt]] * 0.5 + score
                if ns > best_score:
                    best_score = ns
                    best_tgt = tgt
                    best_found = True
            if best_found:
                node_score[n] = best_score
                best_edge[n] = best_tgt
            for src, _ in self.in_[n]:
                visited.add((src, n))
                if all((src, t) in visited for t, _ in self.out[src]):
                    queue.append(src)
        path = []
        prev = 0
        while True:
            path.append(prev)
            if prev not in best_edge:
                break
            prev = best_edge[prev]
        return path

    def consensus(self, min_weight: int = 0) -> str:
        path = self.best_path()
        cns, weights = [], []
        for n in path:
            if self.base[n] in ("^", "$"):
                continue
            cns.append(self.base[n])
            weights.append(self.weight[n])
        offs, best_offs, length = 0, 0, 0
        met = False
        idx = 0
        for w in weights:
            if not met and w >= min_weight:
                offs = idx
                met = True
            elif met and w < min_weight:
                if idx - offs > length:
                    best_offs = offs
                    length = idx - offs
                met = False
            idx += 1
        if met and idx - offs > length:
            best_offs = offs
            length = idx - offs
        return "".join(cns[best_offs:best_offs + length])


def reduced_window_consensus(skeleton: str,
                             alns: List[Tuple[int, str, str, int]],
                             min_weight: int = 0) -> str:
    """One window through the reduced pipeline (spec path)."""
    t = extract_window_tables(len(skeleton), alns)
    g = _RGraph(skeleton, t)
    g.merge_nodes()
    return g.consensus(min_weight)
