"""Build and load the CUDA kernels of ``csrc/`` (plain C interface, ctypes).

Three libraries: ``csrc/banded_static.cu`` (the static band,
:func:`get_lib`), ``csrc/banded_adaptive.cu`` (the adaptive band,
:func:`get_adaptive_lib`) and ``csrc/seed_mesh.cu`` (the mesh seeder's
histogram and dedup, :func:`get_seed_lib`).  Each is compiled with nvcc
on first use into the port's ``_build/`` directory, under a name that
carries the hash of the source and the command, so ``python3
chip_smoke.py`` on a fresh checkout builds it.  A failed build raises: there is no fallback to the
plain versions.  nvcc is taken from ``$CUDA_HOME/bin`` as PyTorch finds
it.
"""

from __future__ import annotations

import ctypes
import os
import threading

from ..utils.nativebuild import build_lib

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SRC = os.path.join(CSRC, "banded_static.cu")
ADAPTIVE_SRC = os.path.join(CSRC, "banded_adaptive.cu")
SEED_SRC = os.path.join(CSRC, "seed_mesh.cu")
SOURCES = (SRC, ADAPTIVE_SRC, SEED_SRC)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_locks = {src: threading.Lock() for src in SOURCES}
_libs: dict = {}


def nvcc_cmd() -> list:
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    return [nvcc, *FLAGS]


def open_lib(src: str, signatures: dict) -> ctypes.CDLL:
    """The library built from ``src`` (built first if needed; raises on
    failure), its functions given ``signatures``: name -> (argtypes),
    each returning int."""
    lib = ctypes.CDLL(build_lib(src, nvcc_cmd()))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    lib.agc_error_string.restype = ctypes.c_char_p
    lib.agc_error_string.argtypes = [ctypes.c_int]
    return lib


def _load(src: str, signatures: dict) -> ctypes.CDLL:
    """:func:`open_lib` of one of SOURCES, once a process."""
    with _locks[src]:
        if src not in _libs:
            _libs[src] = open_lib(src, signatures)
        return _libs[src]


_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SEED_SIGNATURES = {
    "agc_seed_block": [_ci] + [_vp] * 6 + [_ci] * 13 + [_vp] * 4,
    "agc_select_candidates": [_ci] + [_vp] * 4 + [_ci] * 5
    + [_cf, _cf, _ci, _ci, _cf, _ci] + [_vp] * 5}


ADAPTIVE_SIGNATURES = {
    "agc_dp_adaptive": [_ci] + [_vp] * 5 + [_ci] * 10 + [_vp] * 8,
    "agc_tb_adaptive": [_ci] + [_vp] * 4 + [_ci] * 5 + [_vp] * 5}


def get_lib() -> ctypes.CDLL:
    """The static-band kernels (``csrc/banded_static.cu``)."""
    return _load(SRC, {
        "agc_dp_static": [_ci, _vp, _vp, _vp] + [_ci] * 8 + [_vp] * 6,
        "agc_tb_static": [_ci, _vp, _vp, _vp] + [_ci] * 5 + [_vp] * 5})


def get_adaptive_lib() -> ctypes.CDLL:
    """The adaptive-band kernels (``csrc/banded_adaptive.cu``)."""
    return _load(ADAPTIVE_SRC, ADAPTIVE_SIGNATURES)


def get_seed_lib() -> ctypes.CDLL:
    """The mesh seeder's kernels (``csrc/seed_mesh.cu``)."""
    return _load(SEED_SRC, SEED_SIGNATURES)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({lib.agc_error_string(code).decode()})")


def need(x, name: str, dtype, shape, device=None) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (on ``device`` when given)."""
    import torch
    if not torch.is_tensor(x) or x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got "
                         f"{getattr(x, 'device', type(x).__name__)}")
    if device is not None and x.device != device:
        raise ValueError(f"{name} must be on {device}, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_sms: dict = {}


def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``."""
    if index not in _sms:
        import torch
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def launch_target(dev):
    """(device index, current stream handle) of a CUDA device."""
    import torch
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream
