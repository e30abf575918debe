"""Intra-stage alignment checkpointing.

Copy of ``aligngraph2_tpu/align/checkpoint.py``.

The reference's checkpoint granularity is whole stages
(AlignGraph2 script/saved_helper.py:3-71): a run killed mid-alignment
redoes the entire aligner invocation.  SURVEY.md §5 calls for intra-stage
checkpoints on top of the stage cache for long (multi-hour, multi-host)
alignment stages — this module provides them.

Format of the ``.part`` file: repeated chunks of

    #CHUNK <n_records> <job_cursor>
    <n_records x 3-line .ref records>

Each chunk is appended atomically-enough (single write + flush) after a
batch of extension jobs completes.  ``resume()`` replays every complete
chunk whose framing is intact, returning the job cursor (units consumed
in the aligner's deterministic job order) and the alignments emitted so
far; the aligner then skips exactly that many units and appends to the
same output set, making a resumed run's final output identical to an
uninterrupted one (the running set also feeds the duplicate filter and
the per-read best-score table, so even those see the same history).

A token derived from the aligner config and the input databases guards
against resuming across changed inputs; each host of a multi-host run
writes its own rank-suffixed part file (the driver gathers per-host
results exactly as for a fresh run).
"""

from __future__ import annotations

import hashlib
import io
import os
from typing import Tuple

from .records import AlignmentSet


def stage_token(cfg, target_db, read_db, ids) -> str:
    """Fingerprint of everything that determines the job stream."""
    h = hashlib.sha256()
    h.update(repr(sorted(
        (k, v) for k, v in vars(cfg).items()
        if not k.startswith("_"))).encode())
    for db in (target_db, read_db):
        h.update(str(len(db)).encode())
        h.update(db.lengths.tobytes())
        h.update("\x00".join(db.names).encode())
    if ids is not None:
        h.update(",".join(str(i) for i in ids).encode())
    return h.hexdigest()[:24]


class AlignCheckpoint:
    """Append-only intra-stage checkpoint for one aligner invocation."""

    def __init__(self, path: str, token: str, flush_s: float = 300.0):
        self.path = path
        self.token = token
        self.flush_s = flush_s
        self._last_flush = None   # perf_counter of last flush
        self._f = None
        self._reset = False       # stale token: truncate on first flush
        self._intact_end = None   # byte offset of end of last intact chunk

    # ---------------- resume ----------------

    def resume(self) -> Tuple[int, AlignmentSet]:
        """(job cursor, alignments so far) from an intact part file;
        (0, empty) when absent, token-mismatched, or unreadable.

        Reads in binary mode so the byte offset of the end of the last
        *intact* chunk is exact; ``flush()`` truncates the file back to
        that offset before appending, so a crash-truncated tail can never
        be followed by valid chunks (which would frame-shift or silently
        drop every later resume)."""
        out = AlignmentSet()
        cursor = 0
        try:
            with open(self.path, "rb") as f:
                head = f.readline().decode("utf-8", "ignore").split()
                if len(head) != 2 or head[0] != "#TOKEN" \
                        or head[1] != self.token:
                    self._reset = True
                    return 0, AlignmentSet()
                self._intact_end = f.tell()
                while True:
                    mark = f.readline().decode("utf-8", "ignore")
                    if not mark:
                        break
                    parts = mark.split()
                    if len(parts) != 3 or parts[0] != "#CHUNK":
                        break
                    try:
                        n, cur = int(parts[1]), int(parts[2])
                    except ValueError:
                        break   # corrupt mark: degrade to the intact prefix
                    lines = []
                    ok = True
                    for _ in range(3 * n):
                        ln = f.readline()
                        if not ln.endswith(b"\n"):
                            ok = False   # truncated mid-chunk: stop here
                            break
                        lines.append(ln.decode("utf-8", "ignore"))
                    if not ok:
                        break
                    try:
                        chunk = AlignmentSet.read_ref_file(
                            io.StringIO("".join(lines)))
                    except ValueError:
                        break
                    if len(chunk) != n:
                        break
                    for a in chunk:
                        out.append(a)
                    cursor = cur
                    self._intact_end = f.tell()
        except OSError:
            self._intact_end = None
            return 0, AlignmentSet()
        return cursor, out

    # ---------------- append ----------------

    def should_flush(self) -> bool:
        import time
        if self._last_flush is None:
            return True
        return time.perf_counter() - self._last_flush >= self.flush_s

    def flush(self, new_alignments, cursor: int) -> None:
        """Append one chunk of alignments emitted since the last flush."""
        import time
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            fresh = self._reset or not os.path.exists(self.path)
            if not fresh and self._intact_end is not None:
                # Drop any crash-truncated tail before appending, so the
                # file never holds a partial chunk followed by valid ones.
                with open(self.path, "r+b") as tf:
                    tf.truncate(self._intact_end)
            self._f = open(self.path, "w" if self._reset else "a")
            if fresh or os.path.getsize(self.path) == 0:
                self._f.write(f"#TOKEN {self.token}\n")
        buf = io.StringIO()
        AlignmentSet(list(new_alignments)).write_ref_file(buf)
        self._f.write(f"#CHUNK {len(new_alignments)} {cursor}\n")
        self._f.write(buf.getvalue())
        self._f.flush()
        self._last_flush = time.perf_counter()

    def close(self, done: bool = False) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
        if done:
            try:
                os.remove(self.path)
            except OSError:
                pass
