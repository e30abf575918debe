"""ctypes bridge to the native traversal core (native/traverse.cpp).

Copy of ``aligngraph2_tpu/traverse/native.py``; ``native/traverse.cpp`` is
a copy of that package's source, built with the same flags into the
port's ``_build/`` directory.  Dropped: the ``ALIGNGRAPH2_TPU_NATIVE_DIR``
override.

The C++ library runs PAlgorithm::travelSequence's whole call tree over
the SoA graph arrays (shared zero-copy), bit-identically to
traverse/walk.py — which stays the readable specification, the fallback
path, and the parity oracle (tests/test_native_traverse.py).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.nativebuild import ensure_lib

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "traverse.cpp")
CMD = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_pi64 = ctypes.POINTER(_i64)
_pi32 = ctypes.POINTER(ctypes.c_int32)
_pu32 = ctypes.POINTER(ctypes.c_uint32)
_pu16 = ctypes.POINTER(ctypes.c_uint16)
_pu8 = ctypes.POINTER(ctypes.c_uint8)


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
        lib.agt_create.restype = ctypes.c_void_p
        lib.agt_create.argtypes = [
            _i64, _i64, _i64,
            _pi64, _pi64, _pu32, _pu32, _pu16, _pu8, _pi64, _pi32, _pi32,
            _i64, _pi64, _pi64,
            _i64, _pi64, _pi64,
            _i64, ctypes.c_double, ctypes.c_double, _i64, _i64, _i64,
        ]
        lib.agt_destroy.argtypes = [ctypes.c_void_p]
        lib.agt_travel.restype = _i64
        lib.agt_travel.argtypes = [
            ctypes.c_void_p, _i64, ctypes.c_int,
            _pi64, _pi64, _i64, _i64,
            ctypes.POINTER(_pi64), ctypes.POINTER(_pi64),
            ctypes.POINTER(_pi64),
        ]
        lib.agt_free.argtypes = [_pi64]
        _lib = lib
        return _lib


def _as(arr: np.ndarray, dtype) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=dtype)


class NativeTraverser:
    """One handle per (graph, mappers, params) — i.e. per TravelState."""

    def __init__(self, st) -> None:
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native traversal unavailable")
        self._lib = lib
        g = st.graph
        # keep every array alive for the handle's lifetime (graph streams
        # are already in their storage dtypes — no widening copies)
        self._keep = [
            _as(g.node_codes, np.int64), _as(g.pos_start, np.int64),
            _as(g.pos_ctg, np.uint32), _as(g.pos_ref, np.uint32),
            _as(g.pos_count, np.uint16), _as(g.used, np.uint8),
            _as(g.edge_start, np.int64), _as(g.edge_to, np.int32),
            _as(g.edge_step, np.int32),
            _as(st.ctg_mapper.lengths, np.int64),
            _as(st.ctg_mapper.start, np.int64),
            _as(st.ref_mapper.lengths, np.int64),
            _as(st.ref_mapper.start, np.int64),
        ]
        k = self._keep
        ptr = lambda a, t: a.ctypes.data_as(t)
        self._h = lib.agt_create(
            g.n_nodes, len(g.pos_node), g.k,
            ptr(k[0], _pi64), ptr(k[1], _pi64), ptr(k[2], _pu32),
            ptr(k[3], _pu32), ptr(k[4], _pu16), ptr(k[5], _pu8),
            ptr(k[6], _pi64), ptr(k[7], _pi32), ptr(k[8], _pi32),
            len(st.ctg_mapper.lengths), ptr(k[9], _pi64),
            ptr(k[10], _pi64),
            len(st.ref_mapper.lengths), ptr(k[11], _pi64),
            ptr(k[12], _pi64),
            st.deviation, st.error_rate, st.start_split, st.min_len,
            st.top_k, getattr(st, "threads", 0))
        if not self._h:
            raise RuntimeError("agt_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.agt_destroy(h)
            self._h = None

    def travel(self, ctg_idx: int, forward: bool, a_nodes: np.ndarray,
               a_qpos: np.ndarray, ctg_len: int
               ) -> List[Tuple[int, int, int]]:
        a_nodes = _as(a_nodes, np.int64)
        a_qpos = _as(a_qpos, np.int64)
        out_n = _pi64()
        out_p = _pi64()
        out_d = _pi64()
        n = self._lib.agt_travel(
            self._h, ctg_idx, 1 if forward else 0,
            a_nodes.ctypes.data_as(_pi64), a_qpos.ctypes.data_as(_pi64),
            len(a_nodes), ctg_len,
            ctypes.byref(out_n), ctypes.byref(out_p), ctypes.byref(out_d))
        try:
            nodes = np.ctypeslib.as_array(out_n, shape=(max(n, 1),))
            poss = np.ctypeslib.as_array(out_p, shape=(max(n, 1),))
            dists = np.ctypeslib.as_array(out_d, shape=(max(n, 1),))
            return [(int(nodes[i]), int(poss[i]), int(dists[i]))
                    for i in range(n)]
        finally:
            self._lib.agt_free(out_n)
            self._lib.agt_free(out_p)
            self._lib.agt_free(out_d)
