"""Build and load ``csrc/banded_static.cu`` (plain C interface, ctypes).

The library is compiled with nvcc on first use into the port's ``_build/``
directory, under a name that carries the hash of the source and the
command, so ``python3 chip_smoke.py`` on a fresh checkout builds it.  A
failed build raises: there is no fallback to the plain versions.  nvcc is
taken from ``$CUDA_HOME/bin`` as PyTorch finds it.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ..utils.nativebuild import build_lib

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "banded_static.cu")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def nvcc_cmd() -> list:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    return [nvcc, *FLAGS]


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (raises on failure)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_lib(SRC, nvcc_cmd()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.agc_dp_static.restype = ci
            lib.agc_dp_static.argtypes = [ci, vp, vp, vp] + [ci] * 8 \
                + [vp] * 6
            lib.agc_tb_static.restype = ci
            lib.agc_tb_static.argtypes = [ci, vp, vp, vp] + [ci] * 5 \
                + [vp] * 5
            lib.agc_error_string.restype = ctypes.c_char_p
            lib.agc_error_string.argtypes = [ci]
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({lib.agc_error_string(code).decode()})")
