"""ctypes bridge to the native seed-hit enumerator (native/seedhits.cpp).

Counterpart of ``aligngraph2_tpu/ops/native.py``; ``native/seedhits.cpp`` is
a copy of that package's source.  The library is built with g++ on first
use into the port's ``_build/`` directory.  Falls back to None when the
toolchain is unavailable; the numpy path in
seedextend.find_candidates_batch is the specification and produces
identical hits.  Bound here: the seeding entry points (``ags_bin``,
``ags_seed``, ``agr_sort_codes``), the solid-k-mer counter of stage 1
(``agk_solid``) and the graph's stride sampler (``ags_stride_sample``).
Dropped: ``expand_moves_native`` (the CUDA traceback writes dense moves)
and the ``ALIGNGRAPH2_TPU_NATIVE_DIR`` sanitizer override.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from ..utils.nativebuild import ensure_lib

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "seedhits.cpp")
CMD = ["g++", "-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_pi64 = ctypes.POINTER(_i64)
_pi32 = ctypes.POINTER(ctypes.c_int32)
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
        lib.ags_seed.restype = _i64
        lib.ags_seed.argtypes = [
            _pu8, _pi64, _i64, _i64,
            _pu16, _pi32, _pi64,
            _i64, _pi32, _pi32, _pi64,
        ]
        lib.ags_stride_sample.restype = _i64
        lib.ags_stride_sample.argtypes = [_pi64, _i64, _i64, _pi64]
        lib.agk_solid.restype = _i64
        lib.agk_solid.argtypes = [
            _pu8, _pi64, _i64, _i64, ctypes.c_double,
            ctypes.POINTER(_pi64), ctypes.POINTER(_i64),
        ]
        lib.agk_free.argtypes = [_pi64]
        lib.ags_bin.restype = _i64
        lib.ags_bin.argtypes = [
            _pu8, _pi64, _i64, _i64,
            _pu16, _pi32,             # dense tables (or NULL)
            _pi32, _i64,              # prefix table, prefix_len
            _pi64, _pi32, _pi32,      # sorted_codes, sorted_tid/local
            _i64,                     # max_occ
            _pi64, _i64,              # db_offsets, n_targets
            _i64, _i64, _i64,         # bin_w, min_hits, n_threads
            _pi32,
            ctypes.POINTER(_pi32), ctypes.POINTER(_pu8),
            ctypes.POINTER(_pi64), ctypes.POINTER(_pi32),
        ]
        lib.ags_bin_free.restype = None
        lib.ags_bin_free.argtypes = [_pi32, _pu8, _pi64, _pi32]
        lib.agr_sort_codes.restype = _i64
        lib.agr_sort_codes.argtypes = [_pi64, _pi64, _i64]
        _lib = lib
        return _lib


def solid_set_native(bases: np.ndarray, read_start: np.ndarray, k: int,
                     threshold: float
                     ) -> Optional[Tuple[np.ndarray, int]]:
    """(sorted solid codes, cutoff) via the native counter, or None.

    A cutoff of 0 returns an empty code array — the caller emits the
    full 4^k universe (the reference's degenerate regime)."""
    lib = get_lib()
    if lib is None:
        return None
    bases = np.ascontiguousarray(bases, np.uint8)
    read_start = np.ascontiguousarray(read_start, np.int64)
    out = _pi64()
    cutoff = _i64()
    n = lib.agk_solid(bases.ctypes.data_as(_pu8),
                      read_start.ctypes.data_as(_pi64),
                      len(read_start) - 1, k, threshold,
                      ctypes.byref(out), ctypes.byref(cutoff))
    if n < 0:
        return None
    try:
        if n == 0 and not out:
            return np.zeros(0, np.int64), int(cutoff.value)
        codes = np.ctypeslib.as_array(out, shape=(max(n, 1),))[:n].copy()
        return codes.astype(np.int64), int(cutoff.value)
    finally:
        if out:
            lib.agk_free(out)


def stride_sample_native(eligible: np.ndarray,
                         stride: int) -> Optional[np.ndarray]:
    """Greedy stride sampling over a sorted position array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    eligible = np.ascontiguousarray(eligible, np.int64)
    out = np.empty(max(len(eligible), 1), np.int64)
    n = lib.ags_stride_sample(eligible.ctypes.data_as(_pi64),
                              len(eligible), stride,
                              out.ctypes.data_as(_pi64))
    return out[:n]


def seed_bin_native(index, bases: np.ndarray, read_start: np.ndarray,
                    bin_w: int, min_hits: int, threads: int = 0):
    """Per-read candidate binning straight from read bases (production
    path of find_candidates_batch; the numpy pack/sort/unique phase in
    ops/seedextend.py is the specification — tests/test_native_seed.py).

    Returns (per_read_counts, tid, forward, diag, hits) with candidates
    concatenated in read order (forward stream first, ascending
    (tid, diagonal-bin) — the numpy path's ordering), or None when no
    native path is available for this index."""
    lib = get_lib()
    if lib is None:
        return None
    dense = index.dense_cnt is not None and index.dense_off is not None
    prefix = getattr(index, "prefix_off", None)
    if not dense and prefix is None:
        return None
    if threads <= 0:
        threads = min(8, os.cpu_count() or 1)
    bases = np.ascontiguousarray(bases, np.uint8)
    read_start = np.ascontiguousarray(read_start, np.int64)
    n_reads = len(read_start) - 1
    tid_t = np.ascontiguousarray(index.sorted_tid, np.int32)
    local_t = np.ascontiguousarray(index.sorted_local, np.int32)
    codes_t = np.ascontiguousarray(index.sorted_codes, np.int64)
    db_off = np.ascontiguousarray(index.db.offsets, np.int64)
    nc = np.zeros(max(n_reads, 1), np.int32)
    p_tid, p_fwd = _pi32(), _pu8()
    p_diag, p_hits = _pi64(), _pi32()
    if dense:
        cnt_t = np.ascontiguousarray(index.dense_cnt, np.uint16)
        off_t = np.ascontiguousarray(index.dense_off, np.int32)
        cnt_p = cnt_t.ctypes.data_as(_pu16)
        off_p = off_t.ctypes.data_as(_pi32)
        pre_p, pre_len = _pi32(), index.k
    else:
        cnt_p, off_p = _pu16(), _pi32()
        pre_t = np.ascontiguousarray(prefix, np.int32)
        pre_p, pre_len = pre_t.ctypes.data_as(_pi32), index.prefix_len
    n = lib.ags_bin(
        bases.ctypes.data_as(_pu8), read_start.ctypes.data_as(_pi64),
        n_reads, index.k, cnt_p, off_p, pre_p, pre_len,
        codes_t.ctypes.data_as(_pi64), tid_t.ctypes.data_as(_pi32),
        local_t.ctypes.data_as(_pi32),
        index.max_occ, db_off.ctypes.data_as(_pi64),
        len(index.db), bin_w, min_hits, threads,
        nc.ctypes.data_as(_pi32),
        ctypes.byref(p_tid), ctypes.byref(p_fwd),
        ctypes.byref(p_diag), ctypes.byref(p_hits))
    if n < 0:
        return None
    try:
        if n == 0:
            z = np.zeros(0, np.int64)
            return (nc[:n_reads], z.astype(np.int32), z.astype(np.uint8),
                    z, z.astype(np.int32))
        tid = np.ctypeslib.as_array(p_tid, shape=(n,)).copy()
        fwd = np.ctypeslib.as_array(p_fwd, shape=(n,)).copy()
        diag = np.ctypeslib.as_array(p_diag, shape=(n,)).copy()
        hits = np.ctypeslib.as_array(p_hits, shape=(n,)).copy()
        return nc[:n_reads], tid, fwd, diag, hits
    finally:
        lib.ags_bin_free(p_tid, p_fwd, p_diag, p_hits)


def sort_codes_native(codes: np.ndarray, pos: np.ndarray) -> bool:
    """Stable in-place co-sort of (codes, pos) by code (k <= 16 codes).

    True on success; False -> caller falls back to np.argsort."""
    lib = get_lib()
    if lib is None or len(codes) != len(pos):
        return False
    if len(codes) and int(codes.max()) >= (1 << 32):
        return False
    if not (codes.flags.c_contiguous and pos.flags.c_contiguous
            and codes.dtype == np.int64 and pos.dtype == np.int64):
        return False
    return lib.agr_sort_codes(codes.ctypes.data_as(_pi64),
                              pos.ctypes.data_as(_pi64),
                              len(codes)) == 0


def seed_hits_native(index, bases: np.ndarray, read_start: np.ndarray
                     ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray]]:
    """(sid, qpos, tpos) hit arrays for a read chunk, or None.

    Requires the index's dense tables (k <= 13)."""
    if index.dense_cnt is None or index.dense_off is None:
        return None
    lib = get_lib()
    if lib is None:
        return None
    bases = np.ascontiguousarray(bases, np.uint8)
    read_start = np.ascontiguousarray(read_start, np.int64)
    cnt_t = np.ascontiguousarray(index.dense_cnt, np.uint16)
    off_t = np.ascontiguousarray(index.dense_off, np.int32)
    pos_t = np.ascontiguousarray(index.sorted_pos, np.int64)
    cap = max(int(len(bases) // 2), 1024)
    while True:
        sid = np.empty(cap, np.int32)
        qpos = np.empty(cap, np.int32)
        tpos = np.empty(cap, np.int64)
        n = lib.ags_seed(
            bases.ctypes.data_as(_pu8), read_start.ctypes.data_as(_pi64),
            len(read_start) - 1, index.k,
            cnt_t.ctypes.data_as(_pu16), off_t.ctypes.data_as(_pi32),
            pos_t.ctypes.data_as(_pi64),
            cap, sid.ctypes.data_as(_pi32), qpos.ctypes.data_as(_pi32),
            tpos.ctypes.data_as(_pi64))
        if n >= 0:
            return sid[:n], qpos[:n], tpos[:n]
        cap = int(-n) + 1024
