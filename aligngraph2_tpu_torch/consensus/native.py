"""ctypes bridge to the native consensus core (native/poacns.cpp).

Counterpart of ``aligngraph2_tpu/consensus/native.py``; ``native/poacns.cpp``
is a copy of that package's source, built with the same flags into the
port's ``_build/`` directory.  The C++ library implements the full pa_cns
per-backbone flow (window slicing, dagcon gap normalization, top-K, POA
graph consensus) with std::thread window parallelism, bit-identically to
``consensus/poa.py`` and ``consensus/window.py`` (the specification).
Bound here: ``get_lib`` and ``consensus_backbone_native``.  The window
encoder and the reduced merge (``encode_windows_native``,
``reduced_consensus_native*``) serve the device consensus and come with
it.
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

