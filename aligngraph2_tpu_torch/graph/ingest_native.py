"""ctypes bridge to the native graph-ingest core (native/ingest.cpp).

Copy of ``aligngraph2_tpu/graph/ingest_native.py``; ``native/ingest.cpp`` is
a copy of that package's source, built with the same flags into the
port's ``_build/`` directory.  Dropped: the ``ALIGNGRAPH2_TPU_NATIVE_DIR``
override.

The Python pass in graph/processor.py (_run_pass + emitters) is the
specification; this module flattens one pass's surviving alignments into
arrays (applying every record-level filter exactly as the emitters do),
hands them to the threaded C++ core, and appends the returned position /
edge streams to the graph.  Falls back to None/False when the toolchain
or the dense node table (k <= 15) is unavailable; results are identical
to the Python pass after the graph's sort-based merges
(tests/test_native_ingest.py, tests/test_torch_graph.py).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ..utils.nativebuild import ensure_lib

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "ingest.cpp")
CMD = ["g++", "-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_pi64 = ctypes.POINTER(_i64)
_ppi64 = ctypes.POINTER(_pi64)
_pi32 = ctypes.POINTER(ctypes.c_int32)
_pu32 = ctypes.POINTER(ctypes.c_uint32)
_pu16 = ctypes.POINTER(ctypes.c_uint16)
_pu8 = ctypes.POINTER(ctypes.c_uint8)
_ppi32 = ctypes.POINTER(_pi32)
_ppu32 = ctypes.POINTER(_pu32)
_ppu16 = ctypes.POINTER(_pu16)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = ensure_lib(_SRC, CMD)
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.agp_ingest_pass.restype = _i64
        lib.agp_ingest_pass.argtypes = [
            _pu8, _pi64, _i64,                       # reads
            _pi64, _pu8, _pu8, _pi64, _pi64, _pi32,  # alignments
            _pi64, _pu8, _pu8,                       # columns
            _i64,                                    # pass2
            _pi64, _pi64, _pu8,                      # contig tables
            _pi64, _pi64, _pi64, _pi64, _pi64,       # AlignReference CSR
            _pi64, _i64,                             # ref mapper
            _pi32, _i64, _i64, _i64,                 # graph + params
            _ppi32, _ppu32, _ppu32, _ppi32, _ppi32, _ppi32,
            _pi64, _pi64,
        ]
        lib.agp_free.argtypes = [ctypes.c_void_p]
        lib.agp_sort3.restype = _i64
        lib.agp_sort3.argtypes = [_pi64, _pi64, _pi64, _i64, _pi64]
        lib.agp_merge_pos2.restype = _i64
        lib.agp_merge_pos2.argtypes = [
            _pi32, _pu32, _pu32, _pu16, _i64, _i64, _i64, _i64,
            _ppi32, _ppu32, _ppu32, _ppu16, _pi64,
        ]
        lib.agp_merge_edges.restype = _i64
        lib.agp_merge_edges.argtypes = [
            _pi32, _pi32, _pi32, _i64,
            _ppi32, _ppi32, _ppi32, _pi64,
        ]
        _lib = lib
        return _lib


def merge_positions_native(node, ctg, ref, cnt, n_nodes: int, eps: int,
                           threads: int = 0):
    """(node, ctg, ref, count) after the full epsilon merge, sorted by
    (node, ctg, ref), in the graph's storage dtypes (int32/uint32/
    uint32/uint16); None -> caller uses the numpy spec path."""
    lib = get_lib()
    if lib is None:
        return None
    if threads <= 0:
        threads = os.cpu_count() or 1
    a_node = _c(node, np.int32)
    a_ctg = _c(ctg, np.uint32)
    a_ref = _c(ref, np.uint32)
    a_cnt = _c(cnt, np.uint16)
    o = [_pi32(), _pu32(), _pu32(), _pu16()]
    out_n = _i64()
    rc = lib.agp_merge_pos2(
        a_node.ctypes.data_as(_pi32), a_ctg.ctypes.data_as(_pu32),
        a_ref.ctypes.data_as(_pu32), a_cnt.ctypes.data_as(_pu16),
        len(a_node), n_nodes, eps, threads,
        ctypes.byref(o[0]), ctypes.byref(o[1]), ctypes.byref(o[2]),
        ctypes.byref(o[3]), ctypes.byref(out_n))
    try:
        if rc != 0:
            return None
        n = int(out_n.value)

        def arr(p, dt):
            if n == 0:
                return np.zeros(0, dt)
            return np.ctypeslib.as_array(p, shape=(n,)).copy()

        return (arr(o[0], np.int32), arr(o[1], np.uint32),
                arr(o[2], np.uint32), arr(o[3], np.uint16))
    finally:
        for p in o:
            if p:
                lib.agp_free(p)


def merge_edges_native(frm, to, step):
    """Exact (from, to, step) dedup in ascending order via the fused
    radix core, int32 in/out; None -> caller falls back."""
    lib = get_lib()
    if lib is None:
        return None
    a_f = _c(frm, np.int32)
    a_t = _c(to, np.int32)
    a_s = _c(step, np.int32)
    o = [_pi32() for _ in range(3)]
    out_n = _i64()
    rc = lib.agp_merge_edges(
        a_f.ctypes.data_as(_pi32), a_t.ctypes.data_as(_pi32),
        a_s.ctypes.data_as(_pi32), len(a_f),
        ctypes.byref(o[0]), ctypes.byref(o[1]), ctypes.byref(o[2]),
        ctypes.byref(out_n))
    try:
        if rc != 0:
            return None
        n = int(out_n.value)

        def arr(p):
            if n == 0:
                return np.zeros(0, np.int32)
            return np.ctypeslib.as_array(p, shape=(n,)).copy()

        return arr(o[0]), arr(o[1]), arr(o[2])
    finally:
        for p in o:
            if p:
                lib.agp_free(p)


def lexsort3_native(k1, k2, k3) -> Optional[np.ndarray]:
    """Permutation equivalent to np.lexsort((k3, k2, k1)) via the native
    radix sort; None -> caller uses numpy.  Keys must be non-negative
    int64-representable (the graph's node ids and flat coordinates are)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(k1)
    perm = np.empty(n, np.int64)
    if n == 0:
        return perm
    a1 = _c(k1, np.int64)
    a2 = _c(k2, np.int64)
    a3 = _c(k3, np.int64)
    rc = lib.agp_sort3(a1.ctypes.data_as(_pi64), a2.ctypes.data_as(_pi64),
                       a3.ctypes.data_as(_pi64), n,
                       perm.ctypes.data_as(_pi64))
    return perm if rc == 0 else None


def _c(a, dt):
    return np.ascontiguousarray(a, dt)


def _prep_pass(pp, pass2: bool):
    """Flatten one pass's surviving alignments (the emitters' record-level
    filters, applied here verbatim) into the core's arrays."""
    cfg = pp.cfg
    read_db = pp.read_db
    n_reads = len(read_db)
    aln_off = np.zeros(n_reads + 1, np.int64)
    strand_l, walk_l, q0_l, t0_l, tgt_l, qd_l, rd_l = [], [], [], [], [], [], []
    if pass2:
        top_k = cfg.read_to_ref_top_k
        ratio = cfg.read_to_ref_ratio
        cov = pp._sorted_cov[pp.group_ref_id] \
            if pp.group_ref_id in pp._sorted_cov else np.zeros(0, np.int64)
        for rid in range(n_reads):
            read_len = read_db.size(rid)
            cnt = 0
            for a in pp._r2r[rid]:
                if 0 <= top_k <= cnt:
                    break
                if pp.ref_db.seq_id(a.ref_name) != pp.group_ref_id:
                    continue
                if (a.qe - a.qb) / max(read_len, 1) < ratio:
                    continue
                end = min(a.re, len(cov))
                max_cov = int(cov[end - 1]) if a.rb < end else 0
                if max_cov < cfg.cov_filter:
                    continue
                strand_l.append(a.forward)
                walk_l.append(True)
                q0_l.append(a.qb if a.forward else read_len - a.qe)
                t0_l.append(a.rb)
                tgt_l.append(pp.group_ref_id)
                qd_l.append(a.qdiff)
                rd_l.append(a.rdiff)
                cnt += 1
            aln_off[rid + 1] = len(strand_l)
    else:
        top_k = cfg.read_to_ctg_top_k
        ratio = cfg.read_to_ctg_ratio
        for rid in range(n_reads):
            read_len = read_db.size(rid)
            cnt = 0
            for a in pp._r2c[rid]:
                if 0 <= top_k <= cnt:
                    break
                cid = pp.ctg_db.seq_id(a.ref_name)
                if cid not in pp.ctg_forward:
                    continue
                if (a.qe - a.qb) / max(read_len, 1) < ratio:
                    continue
                clen = pp.ctg_db.size(cid)
                if a.re >= clen or a.rb >= clen:
                    continue
                fwd_c = pp.ctg_forward[cid]
                if fwd_c:
                    strand_l.append(a.forward)
                    q0_l.append(a.qb if a.forward else read_len - a.qe)
                    t0_l.append(a.rb)
                else:
                    strand_l.append(not a.forward)
                    q0_l.append(read_len - a.qe if a.forward else a.qb)
                    t0_l.append(clen - a.re)
                walk_l.append(fwd_c)
                tgt_l.append(cid)
                qd_l.append(a.qdiff)
                rd_l.append(a.rdiff)
                cnt += 1
            aln_off[rid + 1] = len(strand_l)
    n_aln = len(strand_l)
    col_off = np.zeros(n_aln + 1, np.int64)
    np.cumsum([len(m) for m in qd_l], out=col_off[1:])
    qd = (np.concatenate(qd_l).astype(np.uint8) if n_aln
          else np.zeros(0, np.uint8))
    rd = (np.concatenate(rd_l).astype(np.uint8) if n_aln
          else np.zeros(0, np.uint8))
    return (aln_off, _c(strand_l, np.uint8), _c(walk_l, np.uint8),
            _c(q0_l, np.int64), _c(t0_l, np.int64), _c(tgt_l, np.int32),
            col_off, qd, rd)


def ingest_pass(pp, pass2: bool, threads: int = 0) -> bool:
    """Run one full ingest pass through the native core; False = caller
    must use the Python pass."""
    lib = get_lib()
    graph = pp.graph
    if lib is None or graph._node_table is None:
        return False
    (aln_off, strand, walk, q0, t0, tgt, col_off, qd, rd) = \
        _prep_pass(pp, pass2)

    n_ctg = len(pp.ctg_db)
    ctg_len = _c(pp.ctg_db.lengths, np.int64)
    ctg_flat_start = _c(pp.ctg_mapper.start[:n_ctg], np.int64)
    ctg_fwd = np.zeros(n_ctg, np.uint8)
    for cid, fwd in pp.ctg_forward.items():
        ctg_fwd[cid] = 1 if fwd else 0
    ar_soff = np.zeros(n_ctg, np.int64)
    ar_eoff = np.zeros(n_ctg, np.int64)
    starts, ridxs, rposs = [], [], []
    s_at = e_at = 0
    for cid in range(n_ctg):
        ar = pp._align_ref.get(cid)
        ar_soff[cid] = s_at
        ar_eoff[cid] = e_at
        if ar is None or ar.start is None:
            starts.append(np.zeros(1, np.int64))
            s_at += 1
            continue
        starts.append(ar.start)
        ridxs.append(ar.ref_idx)
        rposs.append(ar.ref_pos)
        s_at += len(ar.start)
        e_at += len(ar.ref_idx)
    ar_start = (np.concatenate(starts) if starts
                else np.zeros(0, np.int64)).astype(np.int64)
    ar_ridx = (np.concatenate(ridxs) if ridxs
               else np.zeros(0, np.int64)).astype(np.int64)
    ar_rpos = (np.concatenate(rposs) if rposs
               else np.zeros(0, np.int64)).astype(np.int64)

    n_ref = len(pp.ref_db)
    ref_flat_start = _c(pp.ref_mapper.start[:n_ref], np.int64)
    ref_flat_group = int(pp.ref_mapper.start[pp.group_ref_id]) \
        if 0 <= pp.group_ref_id < n_ref else 0
    node_table = graph._node_table   # int32, contiguous by construction

    read_codes = _c(pp.read_db.codes, np.uint8)
    read_off = _c(pp.read_db.offsets, np.int64)
    if threads <= 0:
        threads = os.cpu_count() or 1

    o = [_pi32(), _pu32(), _pu32(), _pi32(), _pi32(), _pi32()]
    n_pos = _i64()
    n_edge = _i64()
    rc = lib.agp_ingest_pass(
        read_codes.ctypes.data_as(_pu8), read_off.ctypes.data_as(_pi64),
        len(pp.read_db),
        aln_off.ctypes.data_as(_pi64), strand.ctypes.data_as(_pu8),
        walk.ctypes.data_as(_pu8), q0.ctypes.data_as(_pi64),
        t0.ctypes.data_as(_pi64), tgt.ctypes.data_as(_pi32),
        col_off.ctypes.data_as(_pi64), qd.ctypes.data_as(_pu8),
        rd.ctypes.data_as(_pu8), 1 if pass2 else 0,
        ctg_len.ctypes.data_as(_pi64),
        ctg_flat_start.ctypes.data_as(_pi64),
        ctg_fwd.ctypes.data_as(_pu8), ar_soff.ctypes.data_as(_pi64),
        ar_eoff.ctypes.data_as(_pi64), ar_start.ctypes.data_as(_pi64),
        ar_ridx.ctypes.data_as(_pi64), ar_rpos.ctypes.data_as(_pi64),
        ref_flat_start.ctypes.data_as(_pi64), ref_flat_group,
        node_table.ctypes.data_as(_pi32), graph.k, pp.cfg.outer_sample,
        threads,
        ctypes.byref(o[0]), ctypes.byref(o[1]), ctypes.byref(o[2]),
        ctypes.byref(o[3]), ctypes.byref(o[4]), ctypes.byref(o[5]),
        ctypes.byref(n_pos), ctypes.byref(n_edge))
    try:
        if rc != 0:
            return False
        np_, ne = int(n_pos.value), int(n_edge.value)

        def arr(p, n):
            if n == 0:
                return np.zeros(0, np.int32)
            return np.ctypeslib.as_array(p, shape=(n,)).copy()

        if np_:
            graph.append_positions(arr(o[0], np_), arr(o[1], np_),
                                   arr(o[2], np_))
        if ne:
            graph.append_edges(arr(o[3], ne), arr(o[4], ne), arr(o[5], ne))
        return True
    finally:
        for p in o:
            if p:
                lib.agp_free(p)
