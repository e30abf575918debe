"""Greedy branch-and-walk graph traversal.

Re-implements the reference PAlgorithm
(AlignGraph2 PAGraph/src/tools/graph/PAlgorithm.{hpp,cpp,tcc}) over the
SoA graph: per contig+orientation, seed on contig-anchored nodes, repeat
{parallel greedy walks from <= top_k candidate start nodes, keep the
longest (or any that leaps into another contig), append with backtracking
overlap trim, detect repeat loops with 4-entry position queues, re-seed
near the last contig anchor ranked by k-mer edit distance}.

Copy of ``aligngraph2_tpu/traverse/walk.py``; its switch to the Python
travel is ``ALIGNGRAPH2_TPU_TORCH_NO_NATIVE=1`` here.

The per-step successor scoring is vectorized (graph.successors grades all
candidate positions of all children in one shot); the walk itself is the
reference's data-dependent greedy loop, kept on host.

Faithful reference details worth flagging:
  * an appended travel whose head has ctg position 0 pops the entire
    accumulated sequence (PAlgorithm::appendSeq loop condition treats 0 as
    "<= everything", PAlgorithm.cpp:120-127);
  * the final non-monotonic-tail trim starts at len - len/90, so it only
    ever inspects the last ~1.1% of the travel (PAlgorithm.cpp:27-44);
  * walk deviation is 2*epsilon and repeat detection uses 2*deviation
    (pagraph.cpp:250, PAlgorithm.cpp:306-330).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Set, Tuple

import numpy as np

from ..coords.mapper import PositionMapper
from ..graph.pagraph import Grade, PAGraph, check_position, is_edge_similar, \
    is_pos_similar
from ..io.seqdb import SeqDatabase
from ..ops.kmer import code_to_str, kmer_codes_np

# a travel element: (node id, global position index, dist)
Step = Tuple[int, int, int]
Travel = List[Step]

END, BRANCH, LIMIT, LEAP = 0, 1, 2, 3


def seq_size(seq: Travel) -> int:
    return sum(s[2] for s in seq)


@dataclass
class TravelState:
    graph: PAGraph
    ctgs: SeqDatabase
    refs: SeqDatabase
    ctg_mapper: PositionMapper
    ref_mapper: PositionMapper
    deviation: int
    error_rate: float
    start_split: float
    min_len: int
    top_k: int = 8
    threads: int = 0     # walk/travel parallelism (0 = hardware auto);
                         # the reference runs <= top_k seed walks and
                         # threadNum/8 contig travels in parallel
                         # (PAlgorithm.cpp:230, PAssembly.cpp:30)
    log: Callable = field(default=lambda *a, **k: None)

    def pos(self, pos_idx: int) -> Tuple[int, int]:
        g = self.graph
        return int(g.pos_ctg[pos_idx]), int(g.pos_ref[pos_idx])

    def make_level(self) -> "_Level":
        """Epoch-stamped visited set over position entries (O(1) vector
        membership, no per-call allocation)."""
        if not hasattr(self, "_stamp_pool"):
            self._stamp_pool = []
        if self._stamp_pool:
            return self._stamp_pool.pop()
        return _Level(np.zeros(len(self.graph.pos_node), np.int64))

    def release_level(self, lvl: "_Level") -> None:
        self._stamp_pool.append(lvl)


class _Level:
    """One filter level of the traversal (walk / travel / global): a
    visited set (epoch-stamped array over position entries) plus a
    visited-ctg-position range table."""

    __slots__ = ("stamp", "epoch", "table")

    def __init__(self, stamp: np.ndarray):
        self.stamp = stamp
        self.epoch = 0
        self.table = None

    def new_epoch(self):
        self.epoch += 1
        self.table = _PosTable()
        return self

    def add(self, pos_idx) -> None:
        self.stamp[pos_idx] = self.epoch

    def member(self, cand: np.ndarray) -> np.ndarray:
        return self.stamp[cand] == self.epoch


def _edge_sim_vec(st: TravelState, p1c, p1r, cand_idx, cand_step):
    """Contig-axis edge similarity of parent -> each candidate."""
    g = st.graph
    s1, _ = is_edge_similar(np.uint64(p1c), np.uint64(p1r),
                            g.pos_ctg[cand_idx], g.pos_ref[cand_idx],
                            cand_step, st.deviation, st.error_rate)
    return s1


def classify_successors(st: TravelState, node: int, pos_idx: int,
                        ctg_range, can_leap: bool, leap_min: float,
                        levels, rev_range) -> List[Tuple[int, int, int]]:
    """PAlgorithm::classifySuccessors: grade all successors, apply the
    composite (global/travel/walk) filter, keep only the best non-empty
    grade class.  Fully vectorized.  Returns
    [(child_node, child_pos_idx, step)]."""
    g = st.graph
    cand_idx, cand_step = g.successors(node, pos_idx, st.deviation,
                                       st.error_rate)
    if len(cand_idx) == 0:
        return []
    p1c, p1r = st.pos(pos_idx)
    pc = g.pos_ctg[cand_idx].astype(np.int64)
    spc0 = pc == 0
    edge_sim = _edge_sim_vec(st, p1c, p1r, cand_idx, cand_step)
    keep = np.ones(len(cand_idx), bool)
    for li, lvl in enumerate(levels):
        in_table = (lvl.table.lo <= pc) & (pc <= lvl.table.hi)
        keep &= ~lvl.member(cand_idx)
        keep &= spc0 | edge_sim | ~in_table
        if li == 0 and rev_range is not None:
            in_rev = (pc >= rev_range[0]) & (pc < rev_range[1])
            keep &= spc0 | ~in_rev
    if not keep.any():
        return []
    cand_idx, cand_step, pc = cand_idx[keep], cand_step[keep], pc[keep]
    grades = check_position(np.uint64(p1c), np.uint64(p1r),
                            g.pos_ctg[cand_idx], g.pos_ref[cand_idx],
                            cand_step, st.deviation, st.error_rate)
    leap = (pc != 0) & ((pc < ctg_range[0]) | (pc >= ctg_range[1]))
    # leap landing gate: within the first leap_min fraction of the target
    drop = np.zeros(len(cand_idx), bool)
    if leap.any():
        lidx, lpos = st.ctg_mapper.single_to_dual(pc[leap])
        sizes = st.ctg_mapper.seq_size(lidx)
        drop_leap = lpos > sizes * leap_min
        if not can_leap:
            drop_leap = np.ones(len(lidx), bool)
        drop[np.flatnonzero(leap)] = drop_leap
    ok = ~drop
    amazing = ok & ((grades == Grade.Amazing) | leap)
    if amazing.any():
        sel = amazing
    else:
        excellent = ok & (grades == Grade.Excellent) & ~leap
        if excellent.any():
            sel = excellent
        else:
            great = ok & (grades == Grade.Good) & ~leap
            if great.any():
                sel = great
            elif can_leap:
                sel = ok & (grades == Grade.Skip) & ~leap
            else:
                sel = np.zeros(len(cand_idx), bool)
    if not sel.any():
        return []
    idxs = np.flatnonzero(sel)
    child_nodes = np.searchsorted(g.pos_start, cand_idx[idxs],
                                  side="right") - 1
    return [(int(n), int(i), int(s)) for n, i, s in
            zip(child_nodes, cand_idx[idxs], cand_step[idxs])]


class _PosTable:
    """(min, max) range of visited ctg flat positions
    (PAlgorithm ctgPosTable helpers)."""

    def __init__(self):
        self.lo = np.iinfo(np.uint32).max
        self.hi = 0

    def insert(self, pos: int):
        if pos == 0:
            return
        self.lo = min(self.lo, pos)
        self.hi = max(self.hi, pos)

    def contains(self, pos: int) -> bool:
        return self.lo <= pos <= self.hi


def walk_straight(st: TravelState, start: Tuple[int, int, int], path: Travel,
                  ctg_range, has_size: int, split_size: int,
                  split_min: float, levels_parent, rev_range,
                  limitation: int = 0) -> int:
    """PAlgorithm::walkStraight: follow unique successors until
    End/Branch/Leap."""
    wl = st.make_level().new_epoch()
    levels = list(levels_parent) + [wl]
    try:
        node, pos_idx, dist = start
        now_size = dist
        path.append(start)
        pc, _ = st.pos(pos_idx)
        if pc != 0 and (pc < ctg_range[0] or pc >= ctg_range[1]):
            return LEAP
        wl.table.insert(pc)
        wl.add(pos_idx)

        while True:
            succ = classify_successors(
                st, path[-1][0], path[-1][1], ctg_range,
                (has_size + now_size) >= split_size, split_min, levels,
                rev_range)
            if not succ:
                return END
            if len(succ) > 1:
                return BRANCH
            sn, si, ss = succ[0]
            wl.add(si)
            spc, _ = st.pos(si)
            wl.table.insert(spc)
            path.append((sn, si, ss))
            now_size += ss
            if spc != 0 and (spc < ctg_range[0] or spc >= ctg_range[1]):
                return LEAP
            if limitation > 0 and len(path) >= limitation:
                return LIMIT
    finally:
        st.release_level(wl)


def graph_travel(st: TravelState, start_node: int, start_pos: int,
                 ctg_range, has_size: int, split_size: int,
                 split_min: float, global_level, rev_range) -> Travel:
    """PAlgorithm::graphTravel: branch-and-walk — walk straight, then at a
    branch walk all successor paths and choose leap > max-abundance branch
    > longest tip."""
    g = st.graph
    tl = st.make_level().new_epoch()
    levels = [global_level, tl]
    seq: Travel = []
    now_size = g.k
    chosen = (start_node, start_pos, g.k)
    tl.table.insert(st.pos(start_pos)[0])

    path: Travel = []
    walk_straight(st, chosen, path, ctg_range, has_size + now_size,
                  split_size, split_min, levels, rev_range)
    paths = [path]
    chosen_idx = 0

    while True:
        chosen_path = paths[chosen_idx]
        for p in chosen_path:
            seq.append(p)
            tl.add(p[1])
            now_size += p[2]
            tl.table.insert(st.pos(p[1])[0])
        last_node, last_pos, _ = seq[-1]
        lpc, _ = st.pos(last_pos)
        if lpc != 0 and (lpc < ctg_range[0] or lpc >= ctg_range[1]):
            break
        succ = classify_successors(st, last_node, last_pos, ctg_range,
                                   (has_size + now_size) >= split_size,
                                   split_min, levels, rev_range)
        leap_l, branch_l, tips_l = [], [], []
        paths = []
        for i, s in enumerate(succ):
            path = []
            status = walk_straight(st, s, path, ctg_range,
                                   has_size + now_size, split_size,
                                   split_min, levels, rev_range)
            paths.append(path)
            if status == LEAP:
                leap_l.append((i, len(path)))
            elif status == END:
                tips_l.append((i, len(path)))
            else:
                branch_l.append((i, len(path)))
        if not leap_l and not tips_l and not branch_l:
            break
        if leap_l:
            chosen_idx = leap_l[0][0]
        elif branch_l:
            best = 0
            for i in range(1, len(branch_l)):
                a1 = int(st.graph.pos_count[succ[branch_l[i][0]][1]])
                a2 = int(st.graph.pos_count[succ[branch_l[best][0]][1]])
                if a1 > a2:
                    best = i
            chosen_idx = branch_l[best][0]
        else:
            best = 0
            for i in range(1, len(tips_l)):
                if tips_l[i][1] > tips_l[best][1]:
                    best = i
            chosen_idx = tips_l[best][0]
    st.release_level(tl)
    return seq


def edit_distance(s1: str, s2: str) -> int:
    """Levenshtein (PAlgorithm::editDistance)."""
    prev = np.arange(len(s2) + 1, dtype=np.int64)
    a1 = np.frombuffer(s1.encode(), np.uint8)
    a2 = np.frombuffer(s2.encode(), np.uint8)
    for i in range(1, len(s1) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        sub = prev[:-1] + (a2 != a1[i - 1])
        for j in range(1, len(s2) + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return int(prev[-1])


def _search_pa_node(st: TravelState, anodes, only_first: bool, pred,
                    window: Optional[Tuple[int, int]] = None
                    ) -> List[Tuple[int, int]]:
    """PAlgorithm::searchPANode / searchPANode2: collect unused, unique
    position entries of contig-anchored nodes passing ``pred``."""
    g = st.graph
    unique: Set[Tuple[int, int]] = set()
    out: List[Tuple[int, int]] = []
    nodes, qpos = anodes
    for nd, qp in zip(nodes, qpos):
        if window is not None:
            if qp < window[0]:
                continue
            if qp > window[1]:
                break
        sl = g.node_positions(int(nd))
        for pi in range(sl.start, sl.stop):
            if g.used[pi]:
                continue
            key = (int(nd), pi)
            if key in unique:
                continue
            c_idx, c_pos = st.ctg_mapper.single_to_dual(int(g.pos_ctg[pi]))
            r_idx, r_pos = st.ref_mapper.single_to_dual(int(g.pos_ref[pi]))
            if pred(int(qp), c_idx, c_pos, r_idx, r_pos):
                out.append(key)
                unique.add(key)
        if out and only_first:
            break
    return out


def filter_sequence(seq: Travel, st: TravelState) -> None:
    """Trim a final non-monotonic tail (PAlgorithm::filterSequence)."""
    window = 10
    if len(seq) < window:
        return
    start_idx = len(seq) - len(seq) // 90
    for i in range(start_idx, len(seq) - window + 1):
        first = int(st.graph.pos_ctg[seq[i][1]])
        second = int(st.graph.pos_ctg[seq[min(len(seq), i + window) - 1][1]])
        if second != 0 and first != 0 and second < first:
            del seq[i + 1:]
            return


def travel_sequence(st: TravelState, ctg_idx: int, forward: bool,
                    use_native: bool = True) -> Travel:
    """PAlgorithm::travelSequence — one contig+orientation's full travel.

    Dispatches to the native core (native/traverse.cpp, bit-identical)
    when available; ``travel_sequence_py`` below is the specification
    and fallback."""
    if use_native and os.environ.get("ALIGNGRAPH2_TPU_TORCH_NO_NATIVE") != "1":
        nt = getattr(st, "_native", None)
        if nt is None and not getattr(st, "_native_failed", False):
            try:
                from .native import NativeTraverser
                nt = NativeTraverser(st)
                st._native = nt
            except (RuntimeError, OSError):
                st._native_failed = True
        if nt is not None:
            g = st.graph
            ctg_codes = st.ctgs.get_codes(ctg_idx, forward)
            a_nodes, a_qpos = g.find_all(kmer_codes_np(ctg_codes, g.k))
            return nt.travel(ctg_idx, forward, a_nodes, a_qpos,
                             st.ctgs.size(ctg_idx))
    return travel_sequence_py(st, ctg_idx, forward)


def travel_sequence_py(st: TravelState, ctg_idx: int, forward: bool
                       ) -> Travel:
    """Pure-Python travelSequence (the specification)."""
    g = st.graph
    top_k = st.top_k
    gl = st.make_level().new_epoch()

    chosen_signed = (ctg_idx + 1) if forward else -(ctg_idx + 1)
    ctg_codes = st.ctgs.get_codes(ctg_idx, forward)
    anodes = g.find_all(kmer_codes_np(ctg_codes, g.k))
    ctg_len = st.ctgs.size(ctg_idx)
    split_len = int(ctg_len * st.start_split)
    split_min = 1 - st.start_split

    ctg_left = int(st.ctg_mapper.dual_to_single(chosen_signed, 0))
    ctg_right = int(st.ctg_mapper.dual_to_single(chosen_signed, ctg_len))
    rev_left = int(st.ctg_mapper.dual_to_single(-chosen_signed, 0))
    rev_right = int(st.ctg_mapper.dual_to_single(-chosen_signed, ctg_len))
    rev_range = (rev_left, rev_right)

    pa_nodes = _search_pa_node(
        st, anodes, True,
        lambda qp, ci, cp, ri, rp: ci == chosen_signed
        and abs(cp - qp) <= st.deviation)
    pa_nodes = pa_nodes[:top_k]

    travel: Travel = []
    var_len = 0
    ctg_que: List[int] = []
    ref_que: List[int] = []
    final_leap = False

    while pa_nodes:
        seqs = [graph_travel(st, nd, pi, (ctg_left, ctg_right), var_len,
                             split_len, split_min, gl, rev_range)
                for nd, pi in pa_nodes]
        longest: Travel = []
        max_len = 0
        choose_ctg = 0
        choose_ref = 0
        leap = False
        for i, (nd_pi, seq) in enumerate(zip(pa_nodes, seqs)):
            ln = seq_size(seq)
            last_c = int(g.pos_ctg[seq[-1][1]])
            leap = last_c != 0 and \
                st.ctg_mapper.single_to_dual(last_c)[0] != chosen_signed
            if not leap and i > 0 and st.min_len > 0 and ln < st.min_len:
                continue
            if ln > max_len or leap:
                max_len = ln
                longest = seq
                choose_ctg = st.ctg_mapper.single_to_dual(
                    int(g.pos_ctg[nd_pi[1]]))[1]
                choose_ref = st.ref_mapper.single_to_dual(
                    int(g.pos_ref[nd_pi[1]]))[1]
                if leap:
                    break
        var_len += append_seq(st, travel, longest)
        if choose_ctg != 0:
            ctg_que.append(choose_ctg)
            del ctg_que[:-4]
        if choose_ref != 0:
            ref_que.append(choose_ref)
            del ref_que[:-4]
        for p in longest:
            gl.add(p[1])
            gl.table.insert(st.pos(p[1])[0])
        ctg_repeat = (len(ctg_que) >= 4
                      and max(ctg_que) - min(ctg_que) <= 2 * st.deviation)
        ref_repeat = (len(ref_que) >= 4
                      and max(ref_que) - min(ref_que) <= 2 * st.deviation)
        if ctg_repeat or ref_repeat or leap:
            final_leap = leap
            break

        # re-seed near the last contig anchor
        last_ctg_pos = 0
        last_kmer = ""
        flag1 = False
        for nd, pi, _ in reversed(travel):
            if not flag1 and int(g.pos_ctg[pi]) != 0:
                ci, cp = st.ctg_mapper.single_to_dual(int(g.pos_ctg[pi]))
                if ci == chosen_signed and cp >= 0:
                    last_ctg_pos = int(cp)
                    last_kmer = code_to_str(int(g.node_codes[nd]), g.k)
                    flag1 = True
                    break
        window = (last_ctg_pos - min(last_ctg_pos, 1000 * st.deviation),
                  last_ctg_pos + 1000 * st.deviation)
        pa_nodes = _search_pa_node(
            st, anodes, False,
            lambda qp, ci, cp, ri, rp: ci == chosen_signed
            and abs(cp - last_ctg_pos) <= st.deviation,
            window=window)
        pa_nodes = [p for p in pa_nodes
                    if gl.stamp[p[1]] != gl.epoch]
        pa_nodes.sort(key=lambda p: edit_distance(
            last_kmer, code_to_str(int(g.node_codes[p[0]]), g.k)))
        pa_nodes = pa_nodes[:top_k]

    st.release_level(gl)
    if not final_leap:
        filter_sequence(travel, st)
    if final_leap and travel:
        di, dp = st.ctg_mapper.single_to_dual(int(g.pos_ctg[travel[-1][1]]))
        tgt_len = st.ctgs.size(abs(di) - 1) if di != 0 else 0
        if abs(di) == ctg_idx + 1 or dp >= tgt_len * (1 - st.start_split):
            travel.pop()
    return travel


def append_seq(st: TravelState, base: Travel, tail: Travel) -> int:
    """PAlgorithm::appendSeq — append with backtracking overlap trim."""
    if not tail:
        return 0
    g = st.graph
    d_len = 0
    head_c = int(g.pos_ctg[tail[0][1]])
    dist = g.k
    while base and (int(g.pos_ctg[base[-1][1]]) == 0
                    or head_c <= int(g.pos_ctg[base[-1][1]])):
        d_len -= base[-1][2]
        base.pop()
    if base:
        dist = head_c - int(g.pos_ctg[base[-1][1]])
    for p in tail:
        d_len += p[2]
        base.append(p)
    first_tail = len(base) - len(tail)
    d_len -= base[first_tail][2] - dist
    base[first_tail] = (base[first_tail][0], base[first_tail][1], dist)
    return d_len


_BASE_UPPER = np.frombuffer(b"ACGT", np.uint8)


def seq_to_string(st: TravelState, seq: Travel, ctg_start_pos: int = 0
                  ) -> str:
    """Vectorized PAlgorithm::seqToString (PAlgorithm.cpp:428-489).

    Character-identical to ``seq_to_string_spec`` below (the scalar
    specification; parity fuzz in tests/test_traverse.py) but emits the
    common case — k-mer suffix characters for steps <= k — with array
    ops.  Only steps longer than k (interpolated lowercase bases pulled
    from contig or reference) fall back to the scalar path, and those
    are rare.  The scalar version cost ~130 s of the 5 Mb bench's
    pagraph stage; this one is ~100x faster."""
    if not seq:
        return ""
    g = st.graph
    k = g.k
    arr = np.asarray(seq, dtype=np.int64)          # (n, 3)
    nodes, pidx, dist = arr[:, 0], arr[:, 1], arr[:, 2]
    codes = g.node_codes[nodes]
    d = np.maximum(dist[1:], 0)
    n_kmer = np.minimum(d, k)                      # k-mer suffix chars
    n_int = d - n_kmer                             # interpolated chars
    starts = np.empty(len(d) + 1, np.int64)
    starts[0] = k
    np.cumsum(d, out=starts[1:])
    starts[1:] += k
    total = int(starts[-1])
    out = np.empty(total, np.uint8)
    # first element: the full k-mer of step 0
    shifts0 = 2 * np.arange(k - 1, -1, -1, dtype=np.int64)
    out[:k] = _BASE_UPPER[(codes[0] >> shifts0) & 3]
    # k-mer suffix chars of every step: char j' of step i is base
    # (n_kmer_i - 1 - j') of codes[i], placed after the step's
    # interpolated run
    tot_kmer = int(n_kmer.sum())
    if tot_kmer:
        rep_codes = np.repeat(codes[1:], n_kmer)
        csum = np.cumsum(n_kmer) - n_kmer
        jj = np.arange(tot_kmer, dtype=np.int64) - np.repeat(csum, n_kmer)
        shifts = 2 * (np.repeat(n_kmer - 1, n_kmer) - jj)
        positions = np.repeat(starts[:-1] + n_int, n_kmer) + jj
        out[positions] = _BASE_UPPER[(rep_codes >> shifts) & 3]
    # interpolated chars (steps longer than k): scalar spec per step
    for i1 in np.flatnonzero(n_int > 0):
        i = int(i1) + 1
        p1 = st.pos(int(pidx[i - 1]))
        p2 = st.pos(int(pidx[i]))
        s1, s2 = is_edge_similar(np.uint64(p1[0]), np.uint64(p1[1]),
                                 np.uint64(p2[0]), np.uint64(p2[1]),
                                 int(dist[i]), st.deviation, st.error_rate)
        use_ctg = bool(s1)
        if not s1 and not s2:
            ps1, _ = is_pos_similar(np.uint64(p1[0]), np.uint64(p1[1]),
                                    np.uint64(p2[0]), np.uint64(p2[1]),
                                    st.deviation)
            use_ctg = bool(ps1)
        db = st.ctgs if use_ctg else st.refs
        mapper = st.ctg_mapper if use_ctg else st.ref_mapper
        prev_p = p1[0] if use_ctg else p1[1]
        now_p = p2[0] if use_ctg else p2[1]
        s_idx, s_pos = mapper.single_to_dual(prev_p)
        e_idx, e_pos = mapper.single_to_dual(now_p)
        kmer_dist = int(dist[i])
        pos_dist = e_pos - s_pos
        sel_idx = abs(e_idx) - 1
        sel_fwd = e_idx > 0
        move = pos_dist / kmer_dist if kmer_dist else 0.0
        base = int(starts[i1])
        # accumulate ref_now += move exactly like seq_to_string_spec:
        # direct j*move multiplication can differ by ulps and flip
        # round() on .5 boundaries, breaking character identity
        ref_now = float(s_pos + k)
        for j in range(int(n_int[i1])):
            rp = int(round(ref_now))
            if 0 <= sel_idx < len(db) and 0 <= rp < db.size(sel_idx):
                out[base + j] = ord("acgt"[db.base_at(sel_idx, rp,
                                                      sel_fwd)])
            else:
                out[base + j] = ord("n")
            ref_now += move
    s = out.tobytes().decode("ascii")
    first_pos = st.ctg_mapper.single_to_dual(int(g.pos_ctg[seq[0][1]]))[1]
    cut = ctg_start_pos - first_pos if ctg_start_pos >= first_pos else 0
    return s[cut:]


def seq_to_string_spec(st: TravelState, seq: Travel, ctg_start_pos: int = 0
                       ) -> str:
    """Scalar PAlgorithm::seqToString — the specification for
    ``seq_to_string`` above: k-mer suffixes for short steps, interpolated
    lowercase bases from contig or reference for long ones
    (PAlgorithm.cpp:428-489)."""
    if not seq:
        return ""
    g = st.graph
    k = g.k
    out = [code_to_str(int(g.node_codes[seq[0][0]]), k)]
    first_pos = st.ctg_mapper.single_to_dual(int(g.pos_ctg[seq[0][1]]))[1]
    for i in range(1, len(seq)):
        prev = seq[i - 1]
        now = seq[i]
        p1 = st.pos(prev[1])
        p2 = st.pos(now[1])
        s1, s2 = is_edge_similar(np.uint64(p1[0]), np.uint64(p1[1]),
                                 np.uint64(p2[0]), np.uint64(p2[1]),
                                 now[2], st.deviation, st.error_rate)
        use_ctg = bool(s1)
        if not s1 and not s2:
            ps1, _ = is_pos_similar(np.uint64(p1[0]), np.uint64(p1[1]),
                                    np.uint64(p2[0]), np.uint64(p2[1]),
                                    st.deviation)
            use_ctg = bool(ps1)
        db = st.ctgs if use_ctg else st.refs
        mapper = st.ctg_mapper if use_ctg else st.ref_mapper
        prev_p = p1[0] if use_ctg else p1[1]
        now_p = p2[0] if use_ctg else p2[1]
        s_idx, s_pos = mapper.single_to_dual(prev_p)
        e_idx, e_pos = mapper.single_to_dual(now_p)
        kmer_dist = now[2]
        pos_dist = e_pos - s_pos
        sel_idx = abs(e_idx) - 1
        sel_fwd = e_idx > 0
        move = pos_dist / kmer_dist if kmer_dist else 0.0
        ref_now = float(s_pos + k)
        kmer = code_to_str(int(g.node_codes[now[0]]), k)
        for j in range(kmer_dist):
            if k - kmer_dist + j >= 0:
                out.append(kmer[k - kmer_dist + j])
            else:
                rp = int(round(ref_now))
                if 0 <= sel_idx < len(db) and 0 <= rp < db.size(sel_idx):
                    out.append("acgt"[db.base_at(sel_idx, rp, sel_fwd)])
                else:
                    out.append("n")
            ref_now += move
    s = "".join(out)
    cut = ctg_start_pos - first_pos if ctg_start_pos >= first_pos else 0
    return s[cut:]
