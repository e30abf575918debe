"""ctypes bridge to the native consensus core (native/poacns.cpp).

Counterpart of ``aligngraph2_tpu/consensus/native.py``; ``native/poacns.cpp``
is a copy of that package's source, built with the same flags into the
port's ``_build/`` directory.  The C++ library implements the full pa_cns
per-backbone flow (window slicing, dagcon gap normalization, top-K, POA
graph consensus) with std::thread window parallelism, bit-identically to
``consensus/poa.py`` and ``consensus/window.py`` (the specification).
Bound here: ``consensus_backbone_native`` (the host path), and the window
encoder and the reduced merge (``encode_windows_native``,
``reduced_consensus_native*``) on either side of the device aggregation
(consensus/device.py).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

from ..utils.nativebuild import ensure_lib

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "poacns.cpp")
CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


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
        i64 = ctypes.c_int64
        lib.agp_consensus_backbone.restype = ctypes.c_int
        lib.agp_consensus_backbone.argtypes = [
            ctypes.c_char_p, i64,                       # backbone, blen
            i64,                                        # n_alns
            ctypes.POINTER(i64), ctypes.POINTER(i64),   # rb, re
            ctypes.POINTER(i64),                        # score
            ctypes.POINTER(ctypes.c_char_p),            # qstrs
            ctypes.POINTER(ctypes.c_char_p),            # tstrs
            i64, i64, i64, i64, i64,                    # window..threads
            ctypes.POINTER(ctypes.c_char_p),            # out
            ctypes.POINTER(i64),                        # out_len
        ]
        lib.agp_free.argtypes = [ctypes.c_char_p]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.agp_encode_windows.restype = ctypes.c_int
        lib.agp_encode_windows.argtypes = [
            ctypes.c_char_p, i64, i64,
            ctypes.POINTER(i64), ctypes.POINTER(i64),
            ctypes.POINTER(i64),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            i64, i64, i64,                              # window,topk,alpha
            ctypes.POINTER(i64), ctypes.POINTER(i64),   # nw, stride
            ctypes.POINTER(u8p), ctypes.POINTER(i64),   # ops, n_cols
            ctypes.POINTER(i32p),                       # col2seg
            ctypes.POINTER(i32p), ctypes.POINTER(i64),  # seg_meta, n_segs
            ctypes.POINTER(i32p),                       # seg_off
            ctypes.POINTER(i32p), ctypes.POINTER(i32p),  # win_col_off/exit
            ctypes.POINTER(i32p), ctypes.POINTER(i64),  # chains, n_chains
        ]
        lib.agp_reduced_consensus.restype = ctypes.c_int
        lib.agp_reduced_consensus.argtypes = [
            ctypes.c_char_p, i64, i64, i64, i64,
            ctypes.POINTER(i64), ctypes.POINTER(i64),   # bb_wt, bb_cov
            i32p, ctypes.POINTER(i64),                  # edges, edge_off
            i32p, ctypes.POINTER(i64),                  # chains, chain_off
            ctypes.c_char_p, i32p, ctypes.POINTER(i64),  # bases/bbpos/off
            i64, i64,                                   # min_weight,threads
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64),
        ]
        _lib = lib
        return _lib


def consensus_backbone_native(backbone: str, alns, window: int, top_k: int,
                              alpha: int, min_weight: int,
                              threads: int) -> Optional[str]:
    """Native pa_cns for one backbone, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(alns)
    i64 = ctypes.c_int64
    rb = (i64 * n)(*(a.rb for a in alns))
    re_ = (i64 * n)(*(a.re for a in alns))
    sc = (i64 * n)(*(a.score for a in alns))
    qstrs = (ctypes.c_char_p * n)(*(a.qstr.encode() for a in alns))
    tstrs = (ctypes.c_char_p * n)(*(a.tstr.encode() for a in alns))
    out = ctypes.c_char_p()
    out_len = i64()
    rc = lib.agp_consensus_backbone(
        backbone.encode(), len(backbone), n, rb, re_, sc, qstrs, tstrs,
        window, top_k, alpha, min_weight, max(threads, 1),
        ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0 or out.value is None:
        return "" if rc == 0 else None
    try:
        return out.value[:out_len.value].decode("ascii")
    finally:
        lib.agp_free(out)


def _copy_free(lib, ptr, n, dtype):
    import numpy as np
    if n == 0:
        arr = np.zeros(0, dtype)
    else:
        arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype,
                                                           copy=True)
    lib.agp_free(ctypes.cast(ptr, ctypes.c_char_p))
    return arr


def encode_windows_native(backbone: str, alns, window: int, top_k: int,
                          alpha: int):
    """Native encoder (agp_encode_windows) -> EncodedWindows, or None.

    Streams are bit-identical to consensus/device.py encode_windows_np
    (tests/test_torch_consensus_device.py)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    from .device import CHAIN_FIELDS, EncodedWindows
    n = len(alns)
    i64 = ctypes.c_int64
    rb = (i64 * n)(*(a.rb for a in alns))
    re_ = (i64 * n)(*(a.re for a in alns))
    sc = (i64 * n)(*(a.score for a in alns))
    qstrs = (ctypes.c_char_p * n)(*(a.qstr.encode() for a in alns))
    tstrs = (ctypes.c_char_p * n)(*(a.tstr.encode() for a in alns))
    nw = i64()
    stride = i64()
    ops = ctypes.POINTER(ctypes.c_uint8)()
    n_cols = i64()
    col2seg = ctypes.POINTER(ctypes.c_int32)()
    seg_meta = ctypes.POINTER(ctypes.c_int32)()
    n_segs = i64()
    seg_off = ctypes.POINTER(ctypes.c_int32)()
    win_col_off = ctypes.POINTER(ctypes.c_int32)()
    win_exit = ctypes.POINTER(ctypes.c_int32)()
    chains = ctypes.POINTER(ctypes.c_int32)()
    n_chains = i64()
    rc = lib.agp_encode_windows(
        backbone.encode(), len(backbone), n, rb, re_, sc, qstrs, tstrs,
        window, top_k, alpha,
        ctypes.byref(nw), ctypes.byref(stride),
        ctypes.byref(ops), ctypes.byref(n_cols), ctypes.byref(col2seg),
        ctypes.byref(seg_meta), ctypes.byref(n_segs),
        ctypes.byref(seg_off), ctypes.byref(win_col_off),
        ctypes.byref(win_exit), ctypes.byref(chains),
        ctypes.byref(n_chains))
    if rc != 0:
        return None
    enc = EncodedWindows(int(nw.value), int(stride.value))
    C, S, NCH = int(n_cols.value), int(n_segs.value), int(n_chains.value)
    enc.ops = _copy_free(lib, ops, C, np.uint8)
    enc.col2seg = _copy_free(lib, col2seg, C, np.int32)
    meta = _copy_free(lib, seg_meta, 3 * S, np.int32).reshape(S, 3)
    enc.seg_win = np.ascontiguousarray(meta[:, 0])
    enc.seg_start = np.ascontiguousarray(meta[:, 1])
    enc.seg_weight = np.ascontiguousarray(meta[:, 2])
    enc.seg_off = _copy_free(lib, seg_off, S + 1, np.int32)
    enc.win_col_off = _copy_free(lib, win_col_off, int(nw.value) + 1,
                                 np.int32)
    enc.win_exit = _copy_free(lib, win_exit, int(nw.value), np.int32)
    ch = _copy_free(lib, chains, 15 * NCH, np.int32).reshape(NCH, 15)
    for i, f in enumerate(CHAIN_FIELDS):
        enc.chains[f] = np.ascontiguousarray(ch[:, i])
    return enc


def reduced_consensus_native(backbone: str, window: int, tables,
                             min_weight: int, threads: int):
    """Native order-keyed reduced merge + best path
    (agp_reduced_consensus), or None.  ``tables``: per-window
    consensus/reduced.py WindowTables."""
    import numpy as np
    nw = len(tables)
    stride = max((t.skeleton_len + 2 for t in tables), default=2)
    bb_wt = np.zeros(nw * stride, np.int64)
    bb_cov = np.zeros(nw * stride, np.int64)
    edge_rows, edge_off = [], [0]
    chain_rows, chain_off = [], [0]
    base_parts, bbpos_parts, base_off = [], [], [0]
    for wi, t in enumerate(tables):
        n = t.skeleton_len + 2
        bb_wt[wi * stride: wi * stride + n] = t.bb_weight
        bb_cov[wi * stride: wi * stride + n] = t.bb_cov
        for (u, v), (c, ft) in t.edges.items():
            edge_rows.append((u, v, c, ft))
        edge_off.append(len(edge_rows))
        for (prev, nxt, bases), (w, crea, fth, ftt, bpos) in \
                t.chains.items():
            chain_rows.append((prev, nxt, len(bases), w, crea, fth, ftt))
            base_parts.append(bases)
            bbpos_parts.append(bpos)
            base_off.append(base_off[-1] + len(bases))
        chain_off.append(len(chain_rows))
    flat = {
        "stride": stride,
        "bb_wt": bb_wt,
        "bb_cov": bb_cov,
        "edges": np.array(edge_rows, np.int32).reshape(-1, 4),
        "edge_off": np.asarray(edge_off, np.int64),
        "chains": np.array(chain_rows, np.int32).reshape(-1, 7),
        "chain_off": np.asarray(chain_off, np.int64),
        "bases": "".join(base_parts).encode(),
        "bbpos": np.array([p for bp in bbpos_parts for p in bp],
                          np.int32),
        "base_off": np.asarray(base_off, np.int64),
    }
    return reduced_consensus_native_flat(backbone, window, nw, flat,
                                         min_weight, threads)


def reduced_consensus_native_flat(backbone: str, window: int, nw: int,
                                  flat: dict, min_weight: int,
                                  threads: int):
    """agp_reduced_consensus on pre-flattened window tables."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    stride = flat["stride"]
    bb_wt = np.ascontiguousarray(flat["bb_wt"], np.int64)
    bb_cov = np.ascontiguousarray(flat["bb_cov"], np.int64)
    edges = np.ascontiguousarray(flat["edges"], np.int32)
    chains = np.ascontiguousarray(flat["chains"], np.int32)
    bases = flat["bases"]
    bbpos = np.ascontiguousarray(flat["bbpos"], np.int32)
    edge_off = np.ascontiguousarray(flat["edge_off"], np.int64)
    chain_off = np.ascontiguousarray(flat["chain_off"], np.int64)
    base_off = np.ascontiguousarray(flat["base_off"], np.int64)
    i64 = ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(i64)
    out = ctypes.c_char_p()
    out_len = i64()
    rc = lib.agp_reduced_consensus(
        backbone.encode(), len(backbone), window, nw, stride,
        bb_wt.ctypes.data_as(i64p), bb_cov.ctypes.data_as(i64p),
        edges.ctypes.data_as(i32p), edge_off.ctypes.data_as(i64p),
        chains.ctypes.data_as(i32p), chain_off.ctypes.data_as(i64p),
        bases, bbpos.ctypes.data_as(i32p),
        base_off.ctypes.data_as(i64p),
        min_weight, max(threads, 1),
        ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0 or out.value is None:
        return "" if rc == 0 else None
    try:
        return out.value[:out_len.value].decode("ascii")
    finally:
        lib.agp_free(out)
