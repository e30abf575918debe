"""Build-on-first-use helper for the port's native host cores and kernels.

Counterpart of ``aligngraph2_tpu/utils/nativebuild.py``, with two changes:

  * every library is built into the port's own ``_build/`` directory
    (listed in ``.gitignore``) instead of beside its source, so the two
    packages never rebuild each other's copy;
  * the library's file name carries the sha256 of the source content and
    the compiler command, and a build goes to a temporary name first and
    is renamed into place, so concurrent processes (pytest workers, the
    parallel builds of ``chip_smoke.py``) never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def _src_hash(src: str, cmd: Sequence[str]) -> str:
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(repr(list(cmd)).encode())
    return h.hexdigest()[:16]


def lib_path(src: str, cmd: Sequence[str]) -> str:
    """Where ``src`` built with ``cmd`` lives: ``_build/lib<stem>.<hash>.so``."""
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}.{_src_hash(src, cmd)}.so")


def build_lib(src: str, cmd: Sequence[str], timeout: float = 600.0) -> str:
    """Path of the library built from ``src`` by ``cmd + [src, -o, out]``,
    building it if no library for this source and command exists yet.
    Raises RuntimeError with the compiler's output when the build fails."""
    so = lib_path(src, cmd)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([*cmd, src, "-o", tmp], capture_output=True,
                             text=True, timeout=timeout)
        if res.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{res.stdout}"
                               f"{res.stderr}")
        with open(so + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def ensure_lib(src: str, cmd: Sequence[str]) -> str | None:
    """Host-core form of :func:`build_lib`: the library path, or None when
    the toolchain is missing or the build fails (the caller then takes its
    numpy specification)."""
    try:
        return build_lib(src, cmd, timeout=300.0)
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        return None
