"""Windowed POA consensus on the run's device — the pa_cns build as
batched torch ops over (alignment, column) tensors.

Counterpart of ``aligngraph2_tpu/consensus/device.py``.  Pipeline (see
consensus/reduced.py for the underlying reduced-graph theory and its
oracle-parity proof):

  1. encode   — slice alignments into windows, gap-normalize, top-k,
     weight (identical semantics to native/poacns.cpp), then flatten to
     a uint8 op stream (2 bits op, 2 bits base) + per-segment metadata
     + per-occurrence insert-chain records (anchors, packed bases,
     creation/first-touch times).  numpy spec here; production C++ in
     native/poacns.cpp (agp_encode_windows).
  2. aggregate (on the device) — the column stream's backbone
     weight/coverage segment sums, match-anchored edge tables (dense
     (window, u, gap) keys with first-touch mins; gap >= GAP_SLOTS falls
     back to a host patch via a mask), ENTER/EXIT edge tables, and the
     chain records sorted and grouped (9-key stable sort, boundary scan,
     wrap-safe group-weight sums, compaction).  The JAX package's two
     jitted functions (``_agg_columns_jit``, ``_chain_sort_jit``) are
     torch ops here: ``index_add_``, ``scatter_reduce`` (amin/amax),
     ``cumsum``, ``cummax`` and chained stable ``torch.sort``.
  3. assemble — host builds consensus/reduced.py WindowTables (or the
     flat arrays) from the aggregated outputs and runs the order-keyed
     merge + best path (production C++ agp_reduced_consensus; _RGraph is
     the spec).

Left out against the JAX package: the power-of-two padding of every
dimension (it only bounded XLA recompiles; the tables are keyed with the
encoding's own window count and stride), and the fallbacks of a failed
step (see ``consensus_backbone_device``).  Changed in the host assembly,
with the same output: ``assemble_flat`` decodes only the bases a group
stores, and ``_patch_flagged`` fixes chains with interior deletions in
one vectorised pass (at 5 Mb these two Python loops took most of the
call).  Every host<->device copy goes through utils/transfer.py.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils import transfer
from ..utils.segment import run_starts, stable_lexsort
from .reduced import WindowTables, _RGraph

GAP_SLOTS = 16      # dense edge table covers gaps 1..GAP_SLOTS-1
MAX_PACK = 64       # chains longer than this use the overflow path

OP_MATCH, OP_DEL, OP_INS = 1, 2, 3

CHAIN_FIELDS = ("win", "prev", "nxt", "length", "b0", "b1", "b2", "b3",
                "w", "creation", "ft_head", "ft_tail", "col_start",
                "bb_start", "flags")
FLAG_OVERFLOW = 1
FLAG_INTERIOR_DELS = 2


class EncodedWindows:
    """Flat op stream + segment/window metadata + chain records for one
    batch of windows (all alignments already sliced/sorted/weighted)."""

    def __init__(self, n_windows: int, window_stride: int):
        self.n_windows = n_windows
        self.window_stride = window_stride          # skeleton_len cap + 2
        self.ops = np.zeros(0, np.uint8)
        self.col2seg = np.zeros(0, np.int32)
        self.seg_win = np.zeros(0, np.int32)
        self.seg_start = np.zeros(0, np.int32)
        self.seg_weight = np.zeros(0, np.int32)
        self.seg_off = np.zeros(1, np.int32)
        self.win_col_off = np.zeros(n_windows + 1, np.int32)
        self.win_exit = np.zeros(n_windows, np.int32)   # skeleton len + 1
        self.chains = {f: np.zeros(0, np.int32) for f in CHAIN_FIELDS}


def encode_windows_np(window_alns: List[List[Tuple[int, str, str, int]]],
                      skeleton_lens: List[int]) -> EncodedWindows:
    """numpy/python specification of the encoder.

    window_alns[w]: (start, qstr, tstr, weight) in processing order
    (already score-sorted, top-k'd, weighted).  The C++ encoder
    (agp_encode_windows) must produce identical streams."""
    nw = len(window_alns)
    stride = max(skeleton_lens) + 2 if skeleton_lens else 2
    enc = EncodedWindows(nw, stride)
    ops_parts: List[np.ndarray] = []
    col2seg_parts: List[np.ndarray] = []
    seg_win, seg_start, seg_weight, seg_off = [], [], [], [0]
    chains = {f: [] for f in CHAIN_FIELDS}
    gcol = 0
    for w_id, (alns, sk_len) in enumerate(zip(window_alns, skeleton_lens)):
        enc.win_col_off[w_id] = gcol
        enc.win_exit[w_id] = sk_len + 1
        t = 0           # per-window column counter
        creation = 0    # per-window insert node counter
        for start, qstr, tstr, w in alns:
            if w <= 0:
                continue
            seg_id = len(seg_win)
            seg_win.append(w_id)
            seg_start.append(start)
            seg_weight.append(w)
            n = len(qstr)
            op_arr = np.zeros(n, np.uint8)
            bb = start
            prev_is_ins = False
            prev_match_bb = -1
            chain = None  # [bases, bb_start, interior_dels, t_head, crea]
            for i, (qb, tb) in enumerate(zip(qstr, tstr)):
                if qb == tb:
                    op_arr[i] = OP_MATCH
                    if chain is not None:
                        _close_chain_np(chains, w_id, chain, bb, w,
                                        2 * t + 2 * i)
                        chain = None
                    bb += 1
                    prev_match_bb = bb - 1
                    prev_is_ins = False
                elif qb == "-":
                    op_arr[i] = OP_DEL
                    if chain is not None:
                        chain[2] = True
                    bb += 1
                else:
                    code = "ACGT".find(qb)
                    if code < 0:
                        code = 0  # seq layer maps non-ACGT to A upstream
                    op_arr[i] = OP_INS | (code << 2)
                    if chain is None:
                        # prev anchor: last match bb, or ENTER
                        prev_anchor = prev_match_bb if prev_match_bb >= 0 \
                            else 0
                        chain = [[qb], bb, False, 2 * t + 2 * i, creation,
                                 gcol + i, prev_anchor]
                    else:
                        chain[0].append(qb)
                    creation += 1
                    prev_is_ins = True
            if chain is not None:
                _close_chain_np(chains, w_id, chain, sk_len + 1, w,
                                2 * (t + n) - 1)
            ops_parts.append(op_arr)
            col2seg_parts.append(np.full(n, seg_id, np.int32))
            gcol += n
            t += n
            seg_off.append(gcol)
    enc.win_col_off[nw] = gcol
    enc.ops = (np.concatenate(ops_parts) if ops_parts
               else np.zeros(0, np.uint8))
    enc.col2seg = (np.concatenate(col2seg_parts) if col2seg_parts
                   else np.zeros(0, np.int32))
    enc.seg_win = np.array(seg_win, np.int32)
    enc.seg_start = np.array(seg_start, np.int32)
    enc.seg_weight = np.array(seg_weight, np.int32)
    enc.seg_off = np.array(seg_off, np.int32)
    for f in CHAIN_FIELDS:
        enc.chains[f] = np.array(chains[f], np.int32)
    return enc


def _close_chain_np(chains: Dict[str, list], w_id: int, chain: list,
                    next_anchor: int, w: int, ft_tail: int) -> None:
    bases, bb_start, interior, ft_head, crea, col_start, prev_anchor = chain
    length = len(bases)
    flags = (FLAG_INTERIOR_DELS if interior else 0)
    words = [0, 0, 0, 0]
    if length > MAX_PACK:
        flags |= FLAG_OVERFLOW
        words[0] = col_start  # unique serial: never pre-merged
    else:
        for j, b in enumerate(bases):
            words[j >> 4] |= "ACGT".find(b) << (2 * (j & 15))
        # Wrap each packed word to int32 exactly like the native encoder
        # (poacns.cpp stores int32; a G/T at base index 15/31/47/63 sets
        # bit 31).  Without this the Python int exceeds int32 and
        # np.array(..., np.int32) raises OverflowError on numpy>=2.
        for k in range(4):
            w32 = words[k] & 0xFFFFFFFF
            words[k] = w32 - (1 << 32) if w32 >= (1 << 31) else w32
    chains["win"].append(w_id)
    chains["prev"].append(prev_anchor)
    chains["nxt"].append(next_anchor)
    chains["length"].append(length)
    for k in range(4):
        chains[f"b{k}"].append(words[k])
    chains["w"].append(w)
    chains["creation"].append(crea)
    chains["ft_head"].append(ft_head)
    chains["ft_tail"].append(ft_tail)
    chains["col_start"].append(col_start)
    chains["bb_start"].append(bb_start)
    chains["flags"].append(flags)



# ------------------- device aggregation -------------------

INT32_MIN = -(1 << 31)
_NONE = 1 << 62     # min over no rows before it is read as INT32_MIN


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 ``t`` modulo 2^32 as int32: JAX's int32 arithmetic wraps."""
    return (torch.remainder(t + (1 << 31), 1 << 32) - (1 << 31)).int()


def _seg_sum(vals: torch.Tensor, keys: torch.Tensor, n: int) -> torch.Tensor:
    """Per-key sums of ``vals`` over keys 0..n-1 (rows keyed n are
    dropped), as int32."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=vals.device)
    out.index_add_(0, keys, vals.long())
    return _wrap32(out[:n])


def _seg_min(vals: torch.Tensor, keys: torch.Tensor, n: int) -> torch.Tensor:
    """Per-key minima of ``vals`` over keys 0..n-1 (rows keyed n are
    dropped), as int32; a key with no row holds int32's minimum, which is
    what JAX's ``-segment_max(-x)`` leaves there."""
    out = torch.full((n + 1,), _NONE, dtype=torch.int64, device=vals.device)
    out.scatter_reduce_(0, keys, vals.long(), "amin", include_self=True)
    out = out[:n]
    return torch.where(out == _NONE, INT32_MIN, out).int()


def _agg_columns(ops, seg_win, seg_start, seg_weight, seg_off, win_col_off,
                 nw: int, stride: int, gap_slots: int):
    """The column aggregation of ``_agg_columns_jit`` (JAX package,
    consensus/device.py:197-303) as torch ops.  Inputs are int64 tensors
    on one device except ``ops`` (uint8); tables come back as int32
    tensors keyed as there: ``win * stride + v`` (backbone, ENTER, EXIT),
    ``(win * stride + u) * (gap_slots - 1) + gap - 1`` (mid edges) and
    ``win`` (ENTER -> EXIT)."""
    C = ops.shape[0]
    dev = ops.device
    iota = torch.arange(C, dtype=torch.int64, device=dev)
    # col -> segment id from the boundary scatter
    marks = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, seg_off[1:], torch.ones_like(seg_off[1:]))
    col2seg = torch.cumsum(marks[:C], 0).clamp_(max=seg_win.shape[0] - 1)
    op = (ops & 3).long()
    valid = op > 0
    sw = seg_win[col2seg]
    w_col = seg_weight[col2seg]
    s_start = seg_start[col2seg]
    s_first = seg_off[col2seg]
    adv = ((op == OP_MATCH) | (op == OP_DEL)) & valid
    g_excl = torch.cumsum(adv.long(), 0) - adv.long()  # advances in [0, col)
    bb = s_start + (g_excl - g_excl[s_first])
    emitted = ((op == OP_MATCH) | (op == OP_INS)) & valid
    cm = torch.cummax(torch.where(emitted, iota, -1), 0).values
    prev_e = torch.cat([cm.new_full((1,), -1), cm[:-1]])
    prev_e = torch.where(prev_e >= s_first, prev_e, -1)
    prev_c = prev_e.clamp(min=0)
    prev_op = (ops[prev_c] & 3).long()
    prev_is_ins = (prev_e >= 0) & (prev_op == OP_INS)
    prev_is_match = (prev_e >= 0) & (prev_op == OP_MATCH)
    u_match = bb[prev_c]
    ft = 2 * (iota - win_col_off[sw])

    nseg_bb = nw * stride
    covk = sw * stride + bb
    bb_cov = _seg_sum(w_col, torch.where(adv, covk, nseg_bb), nseg_bb)
    is_m = (op == OP_MATCH) & valid
    bb_wt = _seg_sum(w_col, torch.where(is_m, covk, nseg_bb), nseg_bb)

    edge_col = is_m & ~prev_is_ins
    gap = bb - u_match
    enter_m = edge_col & (prev_e < 0)
    mid_m = edge_col & prev_is_match & (gap < gap_slots)
    long_m = edge_col & prev_is_match & (gap >= gap_slots)

    def dense(mask, key, nsegs):
        k = torch.where(mask, key, nsegs)
        return _seg_sum(w_col, k, nsegs), _seg_min(ft, k, nsegs)

    enter_w, enter_ft = dense(enter_m, covk, nseg_bb)
    midk = ((sw * stride + u_match) * (gap_slots - 1)
            + torch.clamp(gap - 1, max=gap_slots - 2))
    mid_w, mid_ft = dense(mid_m, midk, nseg_bb * (gap_slots - 1))

    # per-segment exit rows (real segments are weight > 0)
    last_col = seg_off[1:] - 1
    real_seg = seg_weight > 0
    le = cm[last_col.clamp(min=0)]
    le = torch.where(real_seg & (le >= seg_off[:-1]), le, -1)
    le_c = le.clamp(min=0)
    le_op = (ops[le_c] & 3).long()
    seg_t_end = 2 * (seg_off[1:] - win_col_off[seg_win]) - 1
    exit_match = (le >= 0) & (le_op == OP_MATCH)
    exitk = torch.where(exit_match, seg_win * stride + bb[le_c], nseg_bb)
    exit_w = _seg_sum(seg_weight, exitk, nseg_bb)
    exit_ft = _seg_min(seg_t_end, exitk, nseg_bb)
    # deletion-only / empty alignments: ENTER -> EXIT
    empty_m = real_seg & (le < 0)
    eek = torch.where(empty_m, seg_win, nw)
    ee_w = _seg_sum(seg_weight, eek, nw)
    ee_ft = _seg_min(seg_t_end, eek, nw)
    return (bb_wt, bb_cov, enter_w, enter_ft, mid_w, mid_ft, exit_w,
            exit_ft, ee_w, ee_ft, long_m)


CHAIN_KEYS = ("win", "prev", "nxt", "length", "b0", "b1", "b2", "b3",
              "creation")
GROUP_FIELDS = CHAIN_KEYS + ("ft_head", "ft_tail", "col_start", "bb_start",
                             "flags", "wsum")


def _chain_sort(ch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The chain grouping of ``_chain_sort_jit`` (JAX package,
    consensus/device.py:306-356) as torch ops: a stable sort on the nine
    keys of CHAIN_KEYS, groups of rows equal on the first eight, each
    group's weight sum with JAX's int32 wrap, and the first row of each
    group.  ``ch``: int32 tensors of CHAIN_FIELDS on one device."""
    order = stable_lexsort([ch[f] for f in CHAIN_KEYS])
    s = {f: ch[f][order] for f in CHAIN_FIELDS}
    same = None
    for f in CHAIN_KEYS[:8]:
        eq = s[f][1:] == s[f][:-1]
        same = eq if same is None else same & eq
    boundary = run_starts(same)
    N = boundary.numel()
    rows = torch.arange(N, dtype=torch.int64, device=boundary.device)
    csum = torch.cumsum(s["w"].long(), 0)
    gstart = torch.cummax(torch.where(boundary, rows, -1), 0).values
    base = torch.where(gstart > 0, csum[(gstart - 1).clamp(min=0)], 0)
    run_sum = _wrap32(csum - base)      # sum of the group up to this row
    endb = torch.cat([boundary[1:], boundary.new_ones(1)])
    # the group's sum lives at its END row; carry it to every row of the
    # group through a max keyed by group id (an empty key holds int32's
    # minimum, as segment_max leaves it; no row reads one)
    gid = torch.cumsum(boundary.long(), 0) - 1
    gsum = torch.full((N,), INT32_MIN, dtype=torch.int64,
                      device=boundary.device)
    gsum.scatter_reduce_(0, gid, torch.where(endb, run_sum, -1).long(),
                         "amax", include_self=True)
    s["wsum"] = gsum[gid].int()
    first = boundary.nonzero().squeeze(1)
    return {f: s[f][first] for f in GROUP_FIELDS}


def aggregate_device(enc: EncodedWindows, device) -> dict:
    """Run the column and chain aggregation on ``device``; returns the
    aggregates as host arrays.

    Keys and layout are those of the JAX package's ``aggregate_device``,
    less its power-of-two padding (which only bounded XLA recompiles):
    ``nw`` and ``stride`` are the encoding's own window count and stride,
    and ``assemble_flat`` / ``assemble_window_tables`` index the tables
    with this ``stride``."""
    dev = torch.device(device)
    nw, stride = enc.n_windows, enc.window_stride
    out = {"nw": nw, "stride": stride}
    C = len(enc.ops)
    if C:
        ops = transfer.to_device(enc.ops, dev)
        seg = [transfer.to_device(a, dev).long() for a in (
            enc.seg_win, enc.seg_start, enc.seg_weight, enc.seg_off,
            enc.win_col_off)]
        res = _agg_columns(ops, *seg, nw, stride, GAP_SLOTS)
        for name, t in zip(("bb_wt", "bb_cov", "enter_w", "enter_ft",
                            "mid_w", "mid_ft", "exit_w", "exit_ft", "ee_w",
                            "ee_ft"), res):
            out[name] = transfer.to_host(t)
        out["long_cols"] = transfer.to_host(res[-1].nonzero().squeeze(1))
    else:
        ns = nw * stride
        for k, size in (("bb_wt", ns), ("bb_cov", ns), ("enter_w", ns),
                        ("enter_ft", ns), ("mid_w", ns * (GAP_SLOTS - 1)),
                        ("mid_ft", ns * (GAP_SLOTS - 1)), ("exit_w", ns),
                        ("exit_ft", ns), ("ee_w", nw), ("ee_ft", nw)):
            out[k] = np.zeros(size, np.int64)
        out["long_cols"] = np.zeros(0, np.int64)

    if len(enc.chains["win"]):
        groups = _chain_sort({f: transfer.to_device(enc.chains[f], dev)
                              for f in CHAIN_FIELDS})
        out["chain_groups"] = {f: transfer.to_host(t)
                               for f, t in groups.items()}
        out["n_chain_groups"] = len(out["chain_groups"]["win"])
    else:
        out["chain_groups"] = {f: np.zeros(0, np.int32) for f in
                               CHAIN_FIELDS + ("wsum",)}
        out["n_chain_groups"] = 0
    return out


# ------------------- assembly -------------------


def assemble_window_tables(enc: EncodedWindows, agg: dict,
                           skeleton_lens: List[int]
                           ) -> List[WindowTables]:
    """Build per-window WindowTables from the device aggregates."""
    stride = agg["stride"]
    gm = GAP_SLOTS - 1
    tables = [WindowTables(L) for L in skeleton_lens]

    bb_wt = agg["bb_wt"]
    bb_cov = agg["bb_cov"]
    for w_id, t in enumerate(tables):
        n = t.skeleton_len + 2
        t.bb_weight[:] = bb_wt[w_id * stride: w_id * stride + n]
        t.bb_cov[:] = bb_cov[w_id * stride: w_id * stride + n]

    # ENTER edges: key = win*stride + v
    nz = np.flatnonzero(agg["enter_w"])
    for k in nz:
        w_id, v = divmod(int(k), stride)
        tables[w_id]._edge(0, v, int(agg["enter_w"][k]),
                           int(agg["enter_ft"][k]))
    # mid edges: key = (win*stride + u) * gm + (gap-1)
    nz = np.flatnonzero(agg["mid_w"])
    for k in nz:
        slot = int(k) % gm
        uk = int(k) // gm
        w_id, u = divmod(uk, stride)
        tables[w_id]._edge(u, u + slot + 1, int(agg["mid_w"][k]),
                           int(agg["mid_ft"][k]))
    # exit edges: key = win*stride + u
    nz = np.flatnonzero(agg["exit_w"])
    for k in nz:
        w_id, u = divmod(int(k), stride)
        tables[w_id]._edge(u, tables[w_id].skeleton_len + 1,
                           int(agg["exit_w"][k]), int(agg["exit_ft"][k]))
    # ENTER->EXIT
    nz = np.flatnonzero(agg["ee_w"])
    for w_id in nz:
        t = tables[int(w_id)]
        t._edge(0, t.skeleton_len + 1, int(agg["ee_w"][w_id]),
                int(agg["ee_ft"][w_id]))
    # long-gap patch: replay those columns on the host
    for c in agg["long_cols"]:
        c = int(c)
        seg = int(enc.col2seg[c])
        w_id = int(enc.seg_win[seg])
        w = int(enc.seg_weight[seg])
        first = int(enc.seg_off[seg])
        opseg = enc.ops[first:c + 1] & 3
        advn = int(np.sum((opseg[:-1] == OP_MATCH)
                          | (opseg[:-1] == OP_DEL)))
        v = int(enc.seg_start[seg]) + advn
        # previous match bb
        prevm = np.flatnonzero(opseg[:-1] == OP_MATCH)
        pm = int(prevm[-1])
        advp = int(np.sum((opseg[:pm] == OP_MATCH)
                          | (opseg[:pm] == OP_DEL)))
        u = int(enc.seg_start[seg]) + advp
        ft = 2 * (c - int(enc.win_col_off[w_id]))
        tables[w_id]._edge(u, v, w, ft)

    # chain groups
    g = agg["chain_groups"]
    for i in range(agg["n_chain_groups"]):
        w_id = int(g["win"][i])
        length = int(g["length"][i])
        flags = int(g["flags"][i])
        if flags & FLAG_OVERFLOW:
            bases = _bases_from_ops(enc, int(g["col_start"][i]), length)
        else:
            words = [int(g[f"b{k}"][i]) for k in range(4)]
            bases = "".join("ACGT"[(words[j >> 4] >> (2 * (j & 15))) & 3]
                            for j in range(length))
        if flags & FLAG_INTERIOR_DELS:
            bpos = _bbpos_from_ops(enc, int(g["col_start"][i]), length,
                                   int(g["bb_start"][i]))
        else:
            bpos = (int(g["bb_start"][i]),) * length
        key = (int(g["prev"][i]), int(g["nxt"][i]), bases)
        t = tables[w_id]
        cur = t.chains.get(key)
        rec = [int(g["wsum"][i]), int(g["creation"][i]),
               int(g["ft_head"][i]), int(g["ft_tail"][i]), bpos]
        if cur is None:
            t.chains[key] = rec
        else:
            # only possible via the overflow path (identical long chains
            # are intentionally not pre-merged); keep both behaviours
            # exact by treating them as the sequential merge would: sum
            # weights, keep the first-created ordering fields
            cur[0] += rec[0]
            if rec[1] < cur[1]:
                cur[1], cur[2], cur[3], cur[4] = rec[1:]
        # NOTE: overflow groups with equal content still merge here via
        # the dict key (prev, nxt, bases) — exact, since bases are read
        # back from the op stream
    return tables


def _bases_from_ops(enc: EncodedWindows, col_start: int, length: int
                    ) -> str:
    out = []
    c = col_start
    while len(out) < length:
        op = enc.ops[c]
        if (op & 3) == OP_INS:
            out.append("ACGT"[(op >> 2) & 3])
        c += 1
    return "".join(out)


def _bbpos_from_ops(enc: EncodedWindows, col_start: int, length: int,
                    bb_start: int) -> tuple:
    out = []
    bb = bb_start
    c = col_start
    while len(out) < length:
        op = enc.ops[c] & 3
        if op == OP_INS:
            out.append(bb)
        elif op == OP_DEL:
            bb += 1
        else:           # a match would end the chain
            break
        c += 1
    return tuple(out)


def assemble_flat(enc: EncodedWindows, agg: dict,
                  skeleton_lens: List[int], stride_out: int) -> dict:
    """Vectorized assembly of the device aggregates into the flat
    arrays agp_reduced_consensus consumes — no python-dict graph pass.

    Row order per window must match WindowTables dict-insertion order
    (initial chain, ENTER, mid, EXIT, ENTER->EXIT, long-gap patches):
    the reduced merge stable-sorts events by first-touch, and the only
    possible ft ties (-1 initials; odd exit times) resolve identically
    under this ordering — see the tie analysis in consensus/reduced.py.
    """
    stride = agg["stride"]
    gm = GAP_SLOTS - 1
    nw = len(skeleton_lens)
    bb_wt = np.zeros(nw * stride_out, np.int64)
    bb_cov = np.zeros(nw * stride_out, np.int64)
    edge_parts, edge_off = [], [0]
    chain_parts, chain_off = [], [0]
    base_parts: List[bytes] = []
    bbpos_parts: List[np.ndarray] = []
    base_lens: List[np.ndarray] = []

    g = agg["chain_groups"]
    ng = agg["n_chain_groups"]
    gwin = g["win"][:ng]
    # groups arrive sorted by window (leading sort key)
    win_lo = np.searchsorted(gwin, np.arange(nw))
    win_hi = np.searchsorted(gwin, np.arange(nw), side="right")
    glens = g["length"][:ng].astype(np.int64)
    gflags = g["flags"][:ng]
    # decode the packed bases of all groups at once, only those stored:
    # group i's first min(length, 64) bases are bases[goff[i]:goff[i + 1]]
    npk = np.minimum(glens, MAX_PACK)
    goff = np.zeros(ng + 1, np.int64)
    np.cumsum(npk, out=goff[1:])
    gi = np.repeat(np.arange(ng), npk)
    j = np.arange(goff[-1]) - goff[gi]
    words = np.stack([g["b0"][:ng], g["b1"][:ng], g["b2"][:ng],
                      g["b3"][:ng]], axis=1).astype(np.uint32)
    codes = (words[gi, j >> 4] >> (2 * (j & 15)).astype(np.uint32)) & 3
    bases = np.frombuffer(b"ACGT", np.uint8)[codes]
    del gi, j, codes
    # for the interior-deletion patch: the batch's INS columns, and the
    # DEL columns before each column
    opsidx = None
    if gflags.any():
        op = enc.ops & 3
        opsidx = (np.flatnonzero(op == OP_INS),
                  np.concatenate([[0], np.cumsum(op == OP_DEL)]))

    # long-gap patches, precomputed per window
    long_by_win: Dict[int, list] = {}
    for c in agg["long_cols"]:
        c = int(c)
        seg = int(enc.col2seg[c])
        w_id = int(enc.seg_win[seg])
        w = int(enc.seg_weight[seg])
        first = int(enc.seg_off[seg])
        opseg = enc.ops[first:c + 1] & 3
        advn = int(np.sum((opseg[:-1] == OP_MATCH)
                          | (opseg[:-1] == OP_DEL)))
        v = int(enc.seg_start[seg]) + advn
        prevm = np.flatnonzero(opseg[:-1] == OP_MATCH)
        pm = int(prevm[-1])
        advp = int(np.sum((opseg[:pm] == OP_MATCH)
                          | (opseg[:pm] == OP_DEL)))
        u = int(enc.seg_start[seg]) + advp
        ft = 2 * (c - int(enc.win_col_off[w_id]))
        long_by_win.setdefault(w_id, []).append((u, v, w, ft))

    for wi, L in enumerate(skeleton_lens):
        n = L + 2
        bb_wt[wi * stride_out: wi * stride_out + n] = \
            agg["bb_wt"][wi * stride: wi * stride + n]
        bb_cov[wi * stride_out: wi * stride_out + n] = \
            agg["bb_cov"][wi * stride: wi * stride + n]
        enter = agg["enter_w"][wi * stride: wi * stride + n]
        enter_ft = agg["enter_ft"][wi * stride: wi * stride + n]
        mid = agg["mid_w"][wi * stride * gm: (wi * stride + n) * gm]
        mid_ft = agg["mid_ft"][wi * stride * gm: (wi * stride + n) * gm]
        exit_w = agg["exit_w"][wi * stride: wi * stride + n]
        exit_ft = agg["exit_ft"][wi * stride: wi * stride + n]
        rows = []
        # initial backbone chain (ft=-1), counts merged from the dense
        # tables where the alignment edge coincides with (i, i+1)
        init = np.zeros((L + 1, 4), np.int64)
        init[:, 0] = np.arange(L + 1)
        init[:, 1] = init[:, 0] + 1
        init[:, 3] = -1
        if L >= 2:
            init[1:L, 2] = mid[gm: L * gm: gm][: L - 1]
        init[0, 2] = enter[1] if n > 1 else 0
        init[L, 2] += exit_w[L]
        rows.append(init)
        # ENTER -> v (v != 1)
        nz = np.flatnonzero(enter)
        nz = nz[nz != 1]
        if len(nz):
            rows.append(np.stack([np.zeros(len(nz), np.int64), nz,
                                  enter[nz], enter_ft[nz]], axis=1))
        # mid edges with gap >= 2 (slot >= 1)
        nzm = np.flatnonzero(mid)
        nzm = nzm[nzm % gm != 0]
        if len(nzm):
            u = nzm // gm
            rows.append(np.stack([u, u + nzm % gm + 1, mid[nzm],
                                  mid_ft[nzm]], axis=1))
        # u -> EXIT (u != L)
        nze = np.flatnonzero(exit_w)
        nze = nze[nze != L]
        if len(nze):
            rows.append(np.stack([nze, np.full(len(nze), L + 1, np.int64),
                                  exit_w[nze], exit_ft[nze]], axis=1))
        # ENTER -> EXIT
        if agg["ee_w"][wi]:
            rows.append(np.array([[0, L + 1, agg["ee_w"][wi],
                                   agg["ee_ft"][wi]]], np.int64))
        # long-gap patches (u, v) disjoint from every dense table range
        patches = long_by_win.get(wi)
        if patches:
            merged: Dict[Tuple[int, int], List[int]] = {}
            for u, v, w, ft in patches:
                e = merged.get((u, v))
                if e is None:
                    merged[(u, v)] = [w, ft]
                else:
                    e[0] += w
                    e[1] = min(e[1], ft)
            rows.append(np.array([(u, v, c, ft) for (u, v), (c, ft)
                                  in merged.items()], np.int64))
        edge_parts.append(np.concatenate(rows).astype(np.int32))
        edge_off.append(edge_off[-1] + len(edge_parts[-1]))

        # chains of this window
        lo, hi = int(win_lo[wi]), int(win_hi[wi])
        if hi > lo:
            sl = slice(lo, hi)
            ch = np.stack([g["prev"][sl], g["nxt"][sl], g["length"][sl],
                           g["wsum"][sl], g["creation"][sl],
                           g["ft_head"][sl], g["ft_tail"][sl]],
                          axis=1).astype(np.int32)
            lens_w = glens[sl]
            # ragged base stream of the decoded bases
            bstream = bases[goff[lo]:goff[hi]]
            bpos = np.repeat(g["bb_start"][sl].astype(np.int64),
                             np.minimum(lens_w, MAX_PACK))
            # patch flagged groups (overflow length / interior dels)
            flagged = np.flatnonzero(gflags[sl])
            if len(flagged):
                boff = np.concatenate(
                    [[0], np.cumsum(np.minimum(lens_w, MAX_PACK))])
                pieces = {"b": bstream, "p": bpos}
                ch, pieces, lens_w = _patch_flagged(
                    enc, g, sl, flagged, ch, pieces, lens_w, boff, opsidx)
                bstream, bpos = pieces["b"], pieces["p"]
            chain_parts.append(ch)
            base_parts.append(bstream.tobytes())
            bbpos_parts.append(bpos.astype(np.int32))
            base_lens.append(lens_w)
            chain_off.append(chain_off[-1] + len(ch))
        else:
            chain_off.append(chain_off[-1])

    all_lens = (np.concatenate(base_lens) if base_lens
                else np.zeros(0, np.int64))
    flat = {
        "stride": stride_out,
        "bb_wt": bb_wt,
        "bb_cov": bb_cov,
        "edges": (np.concatenate(edge_parts) if edge_parts
                  else np.zeros((0, 4), np.int32)),
        "edge_off": np.asarray(edge_off, np.int64),
        "chains": (np.concatenate(chain_parts) if chain_parts
                   else np.zeros((0, 7), np.int32)),
        "chain_off": np.asarray(chain_off, np.int64),
        "bases": b"".join(base_parts),
        "bbpos": (np.concatenate(bbpos_parts) if bbpos_parts
                  else np.zeros(0, np.int32)),
        "base_off": np.concatenate(
            [[0], np.cumsum(all_lens)]).astype(np.int64),
    }
    return flat


def _patch_flagged(enc, g, sl, flagged, ch, pieces, lens_w, boff, opsidx):
    """Fix base/bbpos streams for overflow-length or interior-del chain
    groups; merges duplicate overflow groups exactly like the sequential
    build would.

    Chains with interior deletions alone (the common flagged case) are
    patched at once: the k-th inserted base of such a chain sits at
    bb_start plus the deletions between the chain's first column and that
    base's column (``opsidx``: the batch's INS columns and its DEL counts
    before each column); its bases are the packed ones.  Overflow chains
    (rare) walk the op stream, as in the JAX package."""
    lo = sl.start
    bstream = pieces["b"]
    bpos = pieces["p"]
    over_m = (g["flags"][lo + flagged] & FLAG_OVERFLOW) != 0
    idel = flagged[~over_m]
    if len(idel):
        ins_cols, del_before = opsidx
        gsl = lo + idel
        cs = g["col_start"][gsl].astype(np.int64)
        n = lens_w[idel].astype(np.int64)
        rep = np.repeat(np.arange(len(idel)), n)
        k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
        cols = ins_cols[np.searchsorted(ins_cols, cs)[rep] + k]
        bpos[boff[idel][rep] + k] = (
            (g["bb_start"][gsl].astype(np.int64) - del_before[cs])[rep]
            + del_before[cols])
    over = flagged[over_m]
    if not len(over):
        return ch, {"b": bstream, "p": bpos}, lens_w
    bl = [bstream[boff[i]:boff[i + 1]] for i in range(len(lens_w))]
    pl = [bpos[boff[i]:boff[i + 1]] for i in range(len(lens_w))]
    keep = np.ones(len(lens_w), bool)
    seen: Dict[Tuple, int] = {}
    for fi in over:
        i = int(fi)
        gi = lo + i
        length = int(g["length"][gi])
        flags = int(g["flags"][gi])
        bases = _bases_from_ops(enc, int(g["col_start"][gi]), length)
        bl[i] = np.frombuffer(bases.encode(), np.uint8)
        if flags & FLAG_INTERIOR_DELS:
            bp = _bbpos_from_ops(enc, int(g["col_start"][gi]),
                                 length, int(g["bb_start"][gi]))
            pl[i] = np.asarray(bp, np.int64)
        else:
            pl[i] = np.full(length, int(g["bb_start"][gi]), np.int64)
        key = (int(ch[i, 0]), int(ch[i, 1]), bl[i].tobytes())
        j = seen.get(key)
        if j is None:
            seen[key] = i
        else:
            # identical overflow chains: merge as the sequential
            # build would (sum weights, keep first-created fields)
            ch[j, 3] += ch[i, 3]
            if ch[i, 4] < ch[j, 4]:
                ch[j, 4:7] = ch[i, 4:7]
                pl[j] = pl[i]
            keep[i] = False
        lens_w[i] = length
    if not keep.all():
        ch = ch[keep]
        bl = [b for k, b in zip(keep, bl) if k]
        pl = [p for k, p in zip(keep, pl) if k]
        lens_w = lens_w[keep]
    return ch, {"b": np.concatenate(bl) if bl else np.zeros(0, np.uint8),
                "p": np.concatenate(pl) if pl else np.zeros(0, np.int64)
                }, lens_w


# ------------------- production entry point -------------------


MAX_BATCH_COLS = int(os.environ.get(
    "ALIGNGRAPH2_TPU_TORCH_CNS_BATCH_COLS", 1 << 23))  # column batch cap


def _slice_enc(enc: EncodedWindows, wlo: int, whi: int) -> EncodedWindows:
    """Restrict an encoding to windows [wlo, whi) with rebased offsets
    (segments and columns are window-contiguous by construction)."""
    slo = int(np.searchsorted(enc.seg_win, wlo, side="left"))
    shi = int(np.searchsorted(enc.seg_win, whi - 1, side="right"))
    clo = int(enc.seg_off[slo])
    chi = int(enc.seg_off[shi])
    sub = EncodedWindows(whi - wlo, enc.window_stride)
    sub.ops = enc.ops[clo:chi]
    sub.col2seg = enc.col2seg[clo:chi] - slo
    sub.seg_win = enc.seg_win[slo:shi] - wlo
    sub.seg_start = enc.seg_start[slo:shi]
    sub.seg_weight = enc.seg_weight[slo:shi]
    sub.seg_off = enc.seg_off[slo:shi + 1] - clo
    sub.win_col_off = enc.win_col_off[wlo:whi + 1] - clo
    sub.win_exit = enc.win_exit[wlo:whi]
    keep = ((enc.chains["win"] >= wlo) & (enc.chains["win"] < whi)
            if len(enc.chains["win"]) else
            np.zeros(0, bool))
    for f in CHAIN_FIELDS:
        sub.chains[f] = enc.chains[f][keep].copy()
    sub.chains["win"] = sub.chains["win"] - wlo
    sub.chains["col_start"] = sub.chains["col_start"] - clo
    return sub


def consensus_backbone_device(backbone: str, alns, window: int,
                              top_k: int, alpha: int, min_weight: int,
                              threads: int = 4, device="cuda") -> str:
    """Production pa_cns flow: native encode -> aggregation on ``device``
    -> native order-keyed reduced merge, in batches of at most
    MAX_BATCH_COLS columns.  Bit-identical to consensus_backbone (gated
    by tests/test_torch_consensus_device.py).

    With ``ALIGNGRAPH2_TPU_TORCH_NO_NATIVE=1`` the encoder is the Python
    spec and the merge is ``_RGraph``; otherwise a native core that is
    missing raises, with no fallback."""
    if not backbone:
        return ""
    no_native = os.environ.get("ALIGNGRAPH2_TPU_TORCH_NO_NATIVE") == "1"
    nw = (len(backbone) + window - 1) // window
    lens = [min(window, len(backbone) - i * window) for i in range(nw)]
    if no_native:
        enc = _encode_spec(backbone, alns, window, top_k, alpha, lens)
    else:
        from .native import encode_windows_native
        enc = encode_windows_native(backbone, list(alns), window, top_k,
                                    alpha)
        if enc is None:
            raise RuntimeError("native/poacns.cpp is not available for "
                               "the device consensus's encoder")
    stride_out = max(lens) + 2
    flats: List[dict] = []
    tables: List[WindowTables] = []
    wlo = 0
    while wlo < nw:
        whi = wlo + 1
        while whi < nw and (enc.win_col_off[whi + 1]
                            - enc.win_col_off[wlo]) <= MAX_BATCH_COLS:
            whi += 1
        sub = _slice_enc(enc, wlo, whi) if (wlo, whi) != (0, nw) else enc
        agg = aggregate_device(sub, device)
        if no_native:
            tables.extend(assemble_window_tables(sub, agg, lens[wlo:whi]))
        else:
            flats.append(assemble_flat(sub, agg, lens[wlo:whi], stride_out))
        wlo = whi
    if no_native:
        outs = []
        for i, t in enumerate(tables):
            g = _RGraph(backbone[i * window: i * window + lens[i]], t)
            g.merge_nodes()
            outs.append(g.consensus(min_weight))
        return "".join(outs)
    from .native import reduced_consensus_native_flat
    flat = flats[0] if len(flats) == 1 else _concat_flats(flats)
    res = reduced_consensus_native_flat(backbone, window, nw, flat,
                                        min_weight, threads)
    if res is None:
        raise RuntimeError("native/poacns.cpp is not available for the "
                           "device consensus's reduced merge")
    return res


def _concat_flats(flats: List[dict]) -> dict:
    out = {"stride": flats[0]["stride"]}
    out["bb_wt"] = np.concatenate([f["bb_wt"] for f in flats])
    out["bb_cov"] = np.concatenate([f["bb_cov"] for f in flats])
    out["edges"] = np.concatenate([f["edges"] for f in flats])
    out["chains"] = np.concatenate([f["chains"] for f in flats])
    out["bases"] = b"".join(f["bases"] for f in flats)
    out["bbpos"] = np.concatenate([f["bbpos"] for f in flats])
    for key in ("edge_off", "chain_off", "base_off"):
        parts = [flats[0][key]]
        for f in flats[1:]:
            parts.append(f[key][1:] + parts[-1][-1])
        out[key] = np.concatenate(parts)
    return out


def _encode_spec(backbone, alns, window, top_k, alpha, lens
                 ) -> EncodedWindows:
    """Pure-python encode fallback via the window.py slicing spec."""
    from .window import slice_into_windows, weight_alignments
    parts = slice_into_windows(alns, len(backbone), window)
    window_alns = []
    for part in parts:
        part.sort(key=lambda p: -p.score)
        del part[top_k:]
        ws = weight_alignments(part, alpha)
        window_alns.append([(p.start, p.qstr, p.tstr, int(w))
                            for p, w in zip(part, ws)])
    return encode_windows_np(window_alns, lens)


# ------------------- spec entry point -------------------


def window_consensus_via_device(skeletons: List[str],
                                window_alns: List[List[Tuple[int, str,
                                                             str, int]]],
                                min_weight: int = 0,
                                device="cuda") -> List[str]:
    """Full reduced pipeline with the aggregation on ``device`` (spec
    encoder and merge)."""
    lens = [len(s) for s in skeletons]
    enc = encode_windows_np(window_alns, lens)
    agg = aggregate_device(enc, device)
    tables = assemble_window_tables(enc, agg, lens)
    outs = []
    for sk, t in zip(skeletons, tables):
        g = _RGraph(sk, t)
        g.merge_nodes()
        outs.append(g.consensus(min_weight))
    return outs
