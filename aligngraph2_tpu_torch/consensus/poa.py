"""Partial-order alignment graph consensus.

Copy of ``aligngraph2_tpu/consensus/poa.py``.

Re-implements the reference AlnGraphBoost (pbdagcon-derived,
AlignGraph2 PAGraph/src/tools/cns/AlnGraphBoost.cpp) without boost:
a backbone chain plus per-alignment weighted insert/match edges, node
merging by base, and a backward DP for the best path with score
``edge.count - 0.5 * coverage(backbone_pos)`` and a -10 penalty for
unsupported backbone nodes (weight == 1).

Alignments must be gap-normalized first (mismatches converted to indel
pairs, gaps pushed right) — ``normalize_gaps`` mirrors dagcon
normalizeGaps (AlignGraph2 PAGraph/src/tools/cns/Alignment.cpp:131).
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def normalize_gaps(qstr: str, tstr: str, push: bool = True
                   ) -> Tuple[str, str]:
    assert len(qstr) == len(tstr)
    q = list(qstr.replace(".", "-"))
    t = list(tstr.replace(".", "-"))
    qn: List[str] = []
    tn: List[str] = []
    for qb, tb in zip(q, t):
        if qb != tb and qb != "-" and tb != "-":
            qn.append("-")
            qn.append(qb)
            tn.append(tb)
            tn.append("-")
        else:
            qn.append(qb)
            tn.append(tb)
    n = len(qn)
    if push:
        for i in range(n - 1):
            if tn[i] == "-":
                j = i
                while j + 1 < n:
                    j += 1
                    c = tn[j]
                    if c != "-":
                        if c == qn[i]:
                            tn[i] = c
                            tn[j] = "-"
                        break
            if qn[i] == "-":
                j = i
                while j + 1 < n:
                    j += 1
                    c = qn[j]
                    if c != "-":
                        if c == tn[i]:
                            qn[i] = c
                            qn[j] = "-"
                        break
    fq: List[str] = []
    ft: List[str] = []
    for qb, tb in zip(qn, tn):
        if qb != "-" or tb != "-":
            fq.append(qb)
            ft.append(tb)
    return "".join(fq), "".join(ft)


class AlnGraph:
    ENTER = 0

    def __init__(self, backbone: str):
        blen = len(backbone)
        self.exit = blen + 1
        n = blen + 2
        self.base = ["^"] + list(backbone) + ["$"]
        self.weight = [0] * n
        self.weight[1:blen + 1] = [1] * blen
        self.coverage = [0] * n
        self.backbone = [True] * n
        self.bbpos = list(range(n))     # backbone vertex for coverage
        self.deleted = [False] * n
        self.out: List[Dict[int, int]] = [dict() for _ in range(n)]
        self.in_: List[Dict[int, int]] = [dict() for _ in range(n)]
        for i in range(blen + 1):
            self.out[i][i + 1] = 0
            self.in_[i + 1][i] = 0

    def _new_node(self, base: str, bbpos: int) -> int:
        self.base.append(base)
        self.weight.append(0)
        self.coverage.append(0)
        self.backbone.append(False)
        self.bbpos.append(bbpos)
        self.deleted.append(False)
        self.out.append(dict())
        self.in_.append(dict())
        return len(self.base) - 1

    def _add_edge(self, u: int, v: int, w: int) -> None:
        self.out[u][v] = self.out[u].get(v, 0) + w
        self.in_[v][u] = self.in_[v].get(u, 0) + w

    def add_aln(self, start: int, qstr: str, tstr: str, weight: int
                ) -> None:
        """start is 1-based backbone position of the first target base
        (dagcon convention, AlnGraphBoost::addAln)."""
        if weight <= 0:
            return
        bb = start
        prev = self.ENTER
        for qb, tb in zip(qstr, tstr):
            if qb == tb:
                cur = bb
                self.coverage[self.bbpos[cur]] += weight
                self.weight[cur] += weight
                self._add_edge(prev, cur, weight)
                bb += 1
                prev = cur
            elif qb == "-" and tb != "-":
                self.coverage[self.bbpos[bb]] += weight
                bb += 1
            elif qb != "-" and tb == "-":
                cur = self._new_node(qb, bb)
                self.weight[cur] += weight
                self._add_edge(prev, cur, weight)
                prev = cur
        self._add_edge(prev, self.exit, weight)

    # ---------------- node merging ----------------

    def merge_nodes(self) -> None:
        from collections import deque
        visited_edges = set()
        queue = deque([self.ENTER])
        while queue:
            u = queue.popleft()
            self._merge_in_nodes(u)
            self._merge_out_nodes(u)
            for v in list(self.out[u]):
                visited_edges.add((u, v))
                if all((w, v) in visited_edges for w in self.in_[v]):
                    queue.append(v)

    def _merge_in_nodes(self, n: int) -> None:
        groups: Dict[str, List[int]] = {}
        for src in self.in_[n]:
            if len(self.out[src]) == 1:
                groups.setdefault(self.base[src], []).append(src)
        for nodes in groups.values():
            if len(nodes) <= 1:
                continue
            nodes.sort()
            an = nodes[0]
            for ni in nodes[1:]:
                # accumulate the single out edge + node weight
                (_, c_ni), = self.out[ni].items()
                (tgt, _), = self.out[an].items()
                self.out[an][tgt] += c_ni
                self.in_[tgt][an] += c_ni
                self.weight[an] += self.weight[ni]
            for ni in nodes[1:]:
                for src, cnt in list(self.in_[ni].items()):
                    self.in_[an][src] = self.in_[an].get(src, 0) + cnt
                    self.out[src][an] = self.out[src].get(an, 0) + cnt
                self._reap(ni)
            self._merge_in_nodes(an)

    def _merge_out_nodes(self, n: int) -> None:
        groups: Dict[str, List[int]] = {}
        for tgt in self.out[n]:
            if len(self.in_[tgt]) == 1:
                groups.setdefault(self.base[tgt], []).append(tgt)
        for nodes in groups.values():
            if len(nodes) <= 1:
                continue
            nodes.sort()
            an = nodes[0]
            for ni in nodes[1:]:
                (_, c_ni), = self.in_[ni].items()
                (src, _), = self.in_[an].items()
                self.in_[an][src] += c_ni
                self.out[src][an] += c_ni
                self.weight[an] += self.weight[ni]
            for ni in nodes[1:]:
                for tgt, cnt in list(self.out[ni].items()):
                    self.out[an][tgt] = self.out[an].get(tgt, 0) + cnt
                    self.in_[tgt][an] = self.in_[tgt].get(an, 0) + cnt
                self._reap(ni)

    def _reap(self, n: int) -> None:
        self.deleted[n] = True
        for src in list(self.in_[n]):
            del self.out[src][n]
        for tgt in list(self.out[n]):
            del self.in_[tgt][n]
        self.in_[n].clear()
        self.out[n].clear()

    # ---------------- best path ----------------

    def best_path(self) -> List[int]:
        from collections import deque
        node_score: Dict[int, float] = {self.exit: 0.0}
        best_edge: Dict[int, int] = {}
        visited = set()
        queue = deque([self.exit])
        while queue:
            n = queue.popleft()
            best_found = False
            best_score = -float("inf")
            best_tgt = -1
            for tgt, cnt in self.out[n].items():
                score = node_score.get(tgt, 0.0)
                if self.backbone[tgt] and self.weight[tgt] == 1:
                    new_score = score - 10.0
                else:
                    new_score = (cnt
                                 - self.coverage[self.bbpos[tgt]] * 0.5
                                 + score)
                if new_score > best_score:
                    best_score = new_score
                    best_tgt = tgt
                    best_found = True
            if best_found:
                node_score[n] = best_score
                best_edge[n] = best_tgt
            for src in self.in_[n]:
                visited.add((src, n))
                if all((src, t) in visited for t in self.out[src]):
                    queue.append(src)
        path = []
        prev = self.ENTER
        while True:
            path.append(prev)
            if prev not in best_edge:
                break
            prev = best_edge[prev]
        return path

    def consensus(self, min_weight: int = 0) -> str:
        path = self.best_path()
        cns = []
        weights = []
        for n in path:
            if self.base[n] in ("^", "$"):
                continue
            cns.append(self.base[n])
            weights.append(self.weight[n])
        # longest contiguous run meeting min_weight
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
