"""Device graph merge phases: epsilon position clustering and exact edge
dedup as torch ops on the caller's device.

Counterpart of ``aligngraph2_tpu/graph/merge_device.py``.  The semantics
are those of ``graph/pagraph.py::PAGraph.merge_positions`` and
``merge_edges`` (the numpy specification): sort every (node, ctg, ref)
triple stably, open a new cluster where a position is not
epsilon-similar to its sorted predecessor (per axis an exact |d| <=
epsilon with both coordinates nonzero, or both zero), sum the counts
with the uint16 saturation of the reference's CountType; keep the first
of equal (from, to, step) edges.  Both return their rows in the spec's
sorted order.

Differences from the JAX package's version:

  * coordinates are carried as int64 on the device, so every input the
    spec takes is exact here (values below 2^63): there is no int32 /
    uint32 guard, no ``None`` for the caller to fall back on, and no
    caught exception -- a failure raises;
  * the multi-key sort is a chain of stable ``torch.sort`` passes, the
    least significant key first, where the JAX version had ``lax.sort``
    with three keys;
  * no power-of-two padding (it only bounded XLA recompiles), and the
    per-cluster count sums are an int64 ``cumsum`` on the device instead
    of on the host.

Narrow unsigned inputs (the graph's uint32 coordinates, uint16 counts)
travel as signed arrays of the same width and are widened on the device,
and results travel back at their input's width.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import transfer
from ..utils.segment import run_starts, stable_lexsort

COUNT_MAX = 0xFFFF   # uint16 CountType cap (KMerAdjNode.hpp:19-23)


def _to_i64(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` (any integer dtype, values below 2^63) as int64 on
    ``device``; a narrow unsigned array is sent at its own width."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.astype(np.int64)
    if a.dtype.kind == "u":
        bits = 8 * a.dtype.itemsize
        t = transfer.to_device(a.view(f"i{a.dtype.itemsize}"), device)
        return t.long() & ((1 << bits) - 1)
    return transfer.to_device(a, device).long()


def _from_i64(t: torch.Tensor, dtype) -> np.ndarray:
    """int64 tensor ``t`` (values representable in ``dtype``) as a host
    array of ``dtype``, copied at that width."""
    dtype = np.dtype(dtype)
    bits = 8 * dtype.itemsize
    if dtype.kind == "u" and bits < 64:
        t = torch.where(t >= 1 << (bits - 1), t - (1 << bits), t)
    out = transfer.to_host(t.to(getattr(torch, f"int{bits}")))
    return out.view(dtype) if dtype.kind == "u" else out


def merge_positions_device(pos_node: np.ndarray, pos_ctg: np.ndarray,
                           pos_ref: np.ndarray, pos_count: np.ndarray,
                           epsilon: int, device
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
    """Cluster positions on ``device``.  Returns (node, ctg, ref, count)
    in the spec's (node, ctg, ref) order: node, ctg and ref in their
    input dtypes, counts as uint16."""
    dev = torch.device(device)
    n = len(pos_node)
    if n == 0:
        return (np.zeros(0, pos_node.dtype), np.zeros(0, pos_ctg.dtype),
                np.zeros(0, pos_ref.dtype), np.zeros(0, np.uint16))
    node, ctg, ref = (_to_i64(a, dev) for a in (pos_node, pos_ctg, pos_ref))
    cnt = _to_i64(pos_count, dev).clamp_(max=COUNT_MAX)
    order = stable_lexsort((node, ctg, ref))
    node, ctg, ref, cnt = node[order], ctg[order], ref[order], cnt[order]
    del order
    pc, cc = ctg[:-1], ctg[1:]
    pr, cr = ref[:-1], ref[1:]
    # PABruijnGraph.cpp:266-273: per axis |d| <= eps with both coords
    # nonzero, or both zero; |d| exact in int64 (not a circular distance)
    s1 = (pc != 0) & (cc != 0) & ((cc - pc).abs() <= epsilon)
    s2 = (pr != 0) & (cr != 0) & ((cr - pr).abs() <= epsilon)
    sim = ((s1 | ((pc == 0) & (cc == 0)))
           & (s2 | ((pr == 0) & (cr == 0))))
    firsts = run_starts(sim & (node[:-1] == node[1:])).nonzero().squeeze(1)
    csum = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(cnt, 0, out=csum[1:])
    ends = torch.cat([firsts[1:], firsts.new_full((1,), n)])
    sums = (csum[ends] - csum[firsts]).clamp_(max=COUNT_MAX)
    return (_from_i64(node[firsts], pos_node.dtype),
            _from_i64(ctg[firsts], pos_ctg.dtype),
            _from_i64(ref[firsts], pos_ref.dtype),
            _from_i64(sums, np.uint16))


def merge_edges_device(edge_from: np.ndarray, edge_to: np.ndarray,
                       edge_step: np.ndarray, n_nodes: int, device
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact (from, to, step) dedup on ``device``.  Returns the distinct
    rows in (from, to, step)-ascending order (the spec's), in their
    input dtypes.  ``n_nodes`` is the JAX version's argument: with int64
    keys no field needs a bound, so it is not read."""
    dev = torch.device(device)
    if len(edge_from) == 0:
        return (np.zeros(0, edge_from.dtype), np.zeros(0, edge_to.dtype),
                np.zeros(0, edge_step.dtype))
    cols = [_to_i64(a, dev) for a in (edge_from, edge_to, edge_step)]
    order = stable_lexsort(cols)
    sf, st, ss = (c[order] for c in cols)
    del cols, order
    dup = (sf[1:] == sf[:-1]) & (st[1:] == st[:-1]) & (ss[1:] == ss[:-1])
    keep = run_starts(dup).nonzero().squeeze(1)
    return (_from_i64(sf[keep], edge_from.dtype),
            _from_i64(st[keep], edge_to.dtype),
            _from_i64(ss[keep], edge_step.dtype))
