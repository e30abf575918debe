"""ctypes bridge to the native FASTA/FASTQ loader (native/fastio.cpp).

Counterpart of ``aligngraph2_tpu/io/native.py``; ``native/fastio.cpp`` is a
copy of that package's source.  The library is built with g++ on first use
into the port's ``_build/`` directory; without a toolchain the pure-Python
readers in ``io/fasta.py`` are used.  Dropped: the
``ALIGNGRAPH2_TPU_NATIVE_DIR`` override that pointed the JAX package at its
sanitizer builds.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.nativebuild import ensure_lib

_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "fastio.cpp")
CMD = ["g++", "-O3", "-shared", "-fPIC"]

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
        lib.agv_load.restype = ctypes.c_void_p
        lib.agv_load.argtypes = [ctypes.c_char_p]
        lib.agv_free.argtypes = [ctypes.c_void_p]
        for fn, res in (("agv_n_seqs", ctypes.c_int64),
                        ("agv_total_len", ctypes.c_int64),
                        ("agv_names_len", ctypes.c_int64)):
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.agv_codes.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.agv_codes.argtypes = [ctypes.c_void_p]
        lib.agv_offsets.restype = ctypes.POINTER(ctypes.c_int64)
        lib.agv_offsets.argtypes = [ctypes.c_void_p]
        lib.agv_names.restype = ctypes.POINTER(ctypes.c_char)
        lib.agv_names.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def load_seqs_native(path: str
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, List[str]]]:
    """(codes, offsets, names) or None if native path unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.agv_load(path.encode())
    if not handle:
        return None
    try:
        n = lib.agv_n_seqs(handle)
        total = lib.agv_total_len(handle)
        nlen = lib.agv_names_len(handle)
        codes = np.ctypeslib.as_array(lib.agv_codes(handle),
                                      shape=(total,)).copy() \
            if total else np.zeros(0, np.uint8)
        offsets = np.ctypeslib.as_array(lib.agv_offsets(handle),
                                        shape=(n + 1,)).copy() \
            if n else np.zeros(1, np.int64)
        raw = ctypes.string_at(lib.agv_names(handle), nlen) if nlen else b""
        names = raw.decode("ascii", "replace").split("\0")[:n]
        return codes, offsets.astype(np.int64), names
    finally:
        lib.agv_free(handle)
