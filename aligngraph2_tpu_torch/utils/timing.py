"""Structured per-stage timing and progress.

Copy of ``aligngraph2_tpu/utils/timing.py``.

Replaces the reference's hand-rolled MyTools (steady-clock timestamps +
a console progress bar embedding live VmSize,
AlignGraph2 PAGraph/src/tools/tools/MyTools.hpp:31-58) with
structured metrics the driver can log or export.
"""

from __future__ import annotations

import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional


def rss_mb() -> Optional[float]:
    """Resident set size in MB (the reference prints VmSize from
    /proc/self/status)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


class StageTimer:
    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.meta: Dict[str, Dict[str, object]] = {}

    @contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) \
                + time.perf_counter() - t0
            m = dict(meta)
            m["rss_mb"] = rss_mb()
            self.meta[name] = m

    def report(self) -> str:
        lines = []
        for name, dt in self.stages.items():
            extra = " ".join(f"{k}={v}" for k, v in self.meta[name].items()
                             if v is not None)
            lines.append(f"{name}: {dt:.3f}s {extra}")
        return "\n".join(lines)


class Progress:
    """Console progress bar (MyTools::progress equivalent)."""

    def __init__(self, total: int, width: int = 70, stream=sys.stderr,
                 enabled: bool = True):
        self.total = max(total, 1)
        self.width = width
        self.stream = stream
        self.enabled = enabled and stream.isatty()
        self.count = 0

    def update(self, n: int = 1) -> None:
        self.count += n
        if not self.enabled:
            return
        frac = min(self.count / self.total, 1.0)
        filled = int(self.width * frac)
        mem = rss_mb()
        memtxt = f" {mem:.0f}MB" if mem else ""
        self.stream.write(f"\r[{'=' * filled}{' ' * (self.width - filled)}]"
                          f" {frac * 100:5.1f}%{memtxt}")
        if frac >= 1.0:
            self.stream.write("\n")
        self.stream.flush()
