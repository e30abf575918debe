"""The plain reference of stage 6's two graph merges: a frozen copy of the
numpy specification the port's ``PAGraph.merge_positions`` and
``merge_edges`` keep beside their native and device routes.

  * positions: sort every (node, ctg, ref) triple stably; a new cluster
    opens where a position is not epsilon-similar to its sorted
    predecessor on the same node (per axis both coordinates nonzero and
    ``|d| <= epsilon``, or both zero); a cluster keeps its first member
    and the sum of its counts, saturated at 0xFFFF (a uint16 count);
  * edges: the distinct (from, to, step) rows in ascending order.

Both return their rows in sorted order and in the input's dtypes (counts
as uint16).  Imports nothing of the port and takes nothing it made.
"""

from __future__ import annotations

import numpy as np

COUNT_MAX = 0xFFFF


def _similar(l_ctg, l_ref, r_ctg, r_ref, epsilon):
    """Per axis: both nonzero and |difference| <= epsilon."""
    d_ctg = np.abs(l_ctg.astype(np.int64) - r_ctg.astype(np.int64))
    d_ref = np.abs(l_ref.astype(np.int64) - r_ref.astype(np.int64))
    s1 = (l_ctg != 0) & (r_ctg != 0) & (d_ctg <= epsilon)
    s2 = (l_ref != 0) & (r_ref != 0) & (d_ref <= epsilon)
    return s1, s2


def merge_positions(node, ctg, ref, count, epsilon: int):
    """(node, ctg, ref, count) of the clusters, in (node, ctg, ref) order."""
    if len(node) == 0:
        return (node[:0].copy(), ctg[:0].copy(), ref[:0].copy(),
                np.zeros(0, np.uint16))
    order = np.lexsort((ref, ctg, node))
    node, ctg, ref, cnt = node[order], ctg[order], ref[order], count[order]
    s1, s2 = _similar(ctg[:-1], ref[:-1], ctg[1:], ref[1:], epsilon)
    sim1 = s1 | ((ctg[:-1] == 0) & (ctg[1:] == 0))
    sim2 = s2 | ((ref[:-1] == 0) & (ref[1:] == 0))
    same_cluster = sim1 & sim2 & (node[:-1] == node[1:])
    boundary = np.concatenate([[True], ~same_cluster])
    cluster_id = np.cumsum(boundary) - 1
    firsts = np.flatnonzero(boundary)
    sums = np.bincount(cluster_id, weights=cnt,
                       minlength=len(firsts)).astype(np.int64)
    return (node[firsts], ctg[firsts], ref[firsts],
            np.minimum(sums, COUNT_MAX).astype(np.uint16))


def merge_edges(frm, to, step):
    """The distinct (from, to, step) rows, ascending."""
    if len(frm) == 0:
        return frm[:0].copy(), to[:0].copy(), step[:0].copy()
    order = np.lexsort((step, to, frm))
    ef, et, es = frm[order], to[order], step[order]
    boundary = np.empty(len(ef), np.bool_)
    boundary[0] = True
    np.not_equal(ef[1:], ef[:-1], out=boundary[1:])
    np.logical_or(boundary[1:], et[1:] != et[:-1], out=boundary[1:])
    np.logical_or(boundary[1:], es[1:] != es[:-1], out=boundary[1:])
    return ef[boundary], et[boundary], es[boundary]
