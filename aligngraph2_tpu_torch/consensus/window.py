"""Windowed consensus driver — the ``pa_cns`` stage.

Re-implements AlignGraph2 PAGraph/src/main/pa_cns.cpp:12-168 +
tools/cns/AlignData.cpp: slice each read->backbone alignment into
``window``-sized backbone windows (gap-aware), keep the top_k alignments
per window by score, min-max-normalize scores into integer weights capped
at alpha, build a POA graph per window, and concatenate per-window
consensus strings.

Copy of ``aligngraph2_tpu/consensus/window.py``, except the dispatch (see
``consensus_backbone``): its ``device`` path runs on the caller's device
and does not fall back to the host.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..align.records import AlignmentSet
from ..config import ConsensusConfig
from .poa import AlnGraph, normalize_gaps

@dataclass
class WindowAln:
    start: int      # 1-based within-window backbone start
    end: int
    qstr: str
    tstr: str
    score: int


def _slice_helper(tstr: str, origin_start: int, slice_start: int,
                  slice_end: int) -> Tuple[int, int]:
    """AlignData::sliceHelper — column range of the target-string covering
    backbone positions [slice_start, slice_end)."""
    cnt = 0
    left = 0
    n = len(tstr)
    while left < n:
        if tstr[left] == "-":
            left += 1
            continue
        if origin_start + cnt >= slice_start:
            break
        cnt += 1
        left += 1
    right = left
    while right < n:
        if tstr[right] == "-":
            right += 1
            continue
        if origin_start + cnt >= slice_end:
            break
        cnt += 1
        right += 1
    return left, right


def slice_into_windows(alns: AlignmentSet, backbone_len: int,
                       window: int) -> List[List[WindowAln]]:
    """AlignData::readFromRefFile — per-window alignment slices."""
    part_num = (backbone_len + window - 1) // window
    parts: List[List[WindowAln]] = [[] for _ in range(part_num)]
    for a in alns:
        to_start, to_end = a.rb, a.re
        if to_end <= to_start:
            continue
        left_part = to_start // window
        right_part = min((to_end - 1) // window, part_num - 1)
        for i in range(left_part, right_part + 1):
            start = (to_start - left_part * window + 1
                     if i == left_part else 1)
            end = (to_end - right_part * window + 1
                   if i == right_part else window)
            lo, hi = _slice_helper(a.tstr, to_start, i * window,
                                   min((i + 1) * window, backbone_len))
            qs = a.qstr[lo:hi]
            ts = a.tstr[lo:hi]
            if not ts:
                continue
            qn, tn = normalize_gaps(qs, ts)
            parts[i].append(WindowAln(start=start, end=end, qstr=qn,
                                      tstr=tn, score=a.score))
    return parts


def weight_alignments(part: List[WindowAln], alpha: int) -> List[int]:
    """AlignData::weightAln — min-max normalize scores to weights 1..alpha."""
    if not part:
        return []
    scores = np.array([p.score for p in part], dtype=np.float64)
    lo, hi = scores.min(), scores.max()
    rng = max(hi - lo, 1.0)
    w = np.maximum(((scores - lo) / rng * alpha).astype(np.int64), 1)
    return list(w)


def consensus_backbone(backbone: str, alns: AlignmentSet,
                       cfg: ConsensusConfig, threads: int = 4,
                       use_native: bool = True, device="cuda") -> str:
    """Full pa_cns flow for one backbone.

    Backend dispatch (ALIGNGRAPH2_TPU_TORCH_CONSENSUS):
      * ``native`` — the host C++ core (native/poacns.cpp),
        one call per backbone, std::thread window parallelism; the
        Python spec below when the core is not available, or with
        ``ALIGNGRAPH2_TPU_TORCH_NO_NATIVE=1``;
      * ``device`` — native encode, the column and chain aggregation as
        torch ops on ``device``, native reduced merge
        (consensus/device.py); a failure raises, with no fallback to the
        host;
      * ``spec`` — the pure-Python spec below;
      * ``auto``, the default — ``native`` (utils/devprobe.py says why).
    All three are bit-identical (tests/test_torch_consensus.py,
    tests/test_torch_consensus_device.py)."""
    from ..utils.backend import resolve_backend
    backend = resolve_backend("ALIGNGRAPH2_TPU_TORCH_CONSENSUS",
                              ("native", "device", "spec"), device)
    if backend == "device":
        from .device import consensus_backbone_device
        return consensus_backbone_device(
            backbone, list(alns), cfg.window, cfg.top_k, cfg.alpha,
            cfg.min_weight, threads, device=device)
    if (backend == "native" and use_native
            and os.environ.get("ALIGNGRAPH2_TPU_TORCH_NO_NATIVE") != "1"):
        from .native import consensus_backbone_native
        res = consensus_backbone_native(
            backbone, list(alns), cfg.window, cfg.top_k, cfg.alpha,
            cfg.min_weight, threads)
        if res is not None:
            return res
    part_num = (len(backbone) + cfg.window - 1) // cfg.window
    parts = slice_into_windows(alns, len(backbone), cfg.window)

    def one(i: int) -> str:
        part = parts[i]
        part.sort(key=lambda p: -p.score)
        del part[cfg.top_k:]
        left = i * cfg.window
        right = min((i + 1) * cfg.window, len(backbone))
        skeleton = backbone[left:right]
        weights = weight_alignments(part, cfg.alpha)
        g = AlnGraph(skeleton)
        for aln, w in zip(part, weights):
            g.add_aln(aln.start, aln.qstr, aln.tstr, int(w))
        g.merge_nodes()
        return g.consensus(cfg.min_weight)

    if threads > 1 and part_num > 1:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            results = list(ex.map(one, range(part_num)))
    else:
        results = [one(i) for i in range(part_num)]
    return "".join(results)
