"""The port's tracing, and a console progress bar.

Tracing rides on ``torch.profiler`` and costs nothing when no profiler
records:

  * :func:`span` opens a ``torch.profiler.record_function`` span, so the
    span lands on the profiler's clock beside the device's events; with
    no profiler recording it is a shared no-op context (entering a
    ``record_function`` costs microseconds even then; asking whether a
    profiler records, a fraction of one);
  * :func:`count` adds to an in-process registry of counters, and
    :func:`counts` returns a copy of it.  The registry holds the latest
    traced stretch: the first :func:`span`, :func:`count` or
    :func:`tracing` call that finds a profiler recording, after one that
    found none, clears it.

The aligner's spans (``align/aligner.py``, ``parallel/sharded.py``;
``X.y`` lies inside ``X``):

  * ``align.index``: the seed index (host) or the mesh's block index;
  * ``align.seed``: host seeding, or the mesh seeder's calls; inside the
    latter ``align.seed.wait``, the blocking copies of the candidate
    tables back to the host;
  * ``align.pack`` (mesh path): the query arrays of each seeder call;
  * ``align.compact`` (mesh path): the host's compaction of the
    candidate tables into live lanes;
  * ``align.prep``: a batch's (or a lane chunk's) host arrays;
  * ``align.dispatch``: queueing the batch on the device; on the mesh
    path the extender's call, with ``align.dispatch.wait``, the blocking
    copies of its results back;
  * ``align.finish``: a batch's records, as ``align.finish.wait`` (the
    single-device path's wait for the batch's event),
    ``align.finish.strings`` (the gapped strings) and
    ``align.finish.emit`` (the record filters and dedup).

Counters: ``extend.lanes`` (the live lanes given to the mesh extender),
``extend.lane_slots`` (the lanes of the shards it launched, padding
included), ``extend.card_strings`` (the live lanes whose gapped strings a
card made: all of them on cards, 0 on the CPU), ``adaptive.rows`` (the rows each lane of the adaptive band ran
on a card, summed), ``adaptive.row_slots`` (a launch's lanes times its
longest lane's rows, summed over launches), ``align.records`` (the
records ``align_reads`` returns), and the mesh seeder's
``seed.read_blocks`` (the (read strand, index block) pairs its seeding
scanned, 2 B NB_l a call and block shard), ``select.candidates`` (the
candidates its selection weighed, B N a call), ``select.scratch_rows``
(the rows of a card's selection whose table lay in the global scratch,
N past 8,192) and ``seed.selected`` (the candidates it kept).
"""

from __future__ import annotations

import sys
from contextlib import nullcontext
from typing import Dict, Optional

import torch
from torch.profiler import record_function

_OFF = nullcontext()
_counts: Dict[str, int] = {}
_was_on = False


def tracing() -> bool:
    """Whether a profiler records now; clears the counters on the first
    call of a traced stretch."""
    global _was_on
    on = torch.autograd._profiler_enabled()
    if on and not _was_on:
        _counts.clear()
    _was_on = on
    return on


def span(name: str):
    """A ``record_function`` span named ``name`` while a profiler
    records, else a no-op context."""
    return record_function(name) if tracing() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if tracing():
        _counts[name] = _counts.get(name, 0) + int(n)


def counts() -> Dict[str, int]:
    """The counters of the latest traced stretch."""
    return dict(_counts)


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
