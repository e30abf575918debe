"""Flat coordinate algebra: (seq, orientation, position) <-> single integer.

Copy of ``aligngraph2_tpu/coords/mapper.py``.

Re-implements the reference PositionMapper
(AlignGraph2 PAGraph/src/tools/position/PositionMapper.cpp:8-75) as
vectorized numpy ops:

  * signed 1-based sequence index: +i = sequence i-1 forward,
    -i = sequence i-1 reverse-complement, 0 = "no position" sentinel.
  * flat coordinate 0 is reserved for the sentinel; the first sequence's
    span starts at its own length, spans are separated by guard gaps so
    that positions of different sequences/orientations can never be within
    epsilon of each other:
        start[0] = len[0]
        start[i] = start[i-1] + 3*len[i-1] + max(len[i-1], len[i])
    forward span of seq i begins at start[i], reverse span at
    start[i] + 2*len[i].
"""

from __future__ import annotations

import numpy as np


class PositionMapper:
    def __init__(self, lengths: np.ndarray):
        lengths = np.asarray(lengths, dtype=np.int64)
        n = len(lengths)
        start = np.zeros(n + 1, dtype=np.int64)
        if n > 0:
            start[0] = lengths[0]
            for i in range(1, n):
                start[i] = (start[i - 1] + 3 * lengths[i - 1]
                            + max(lengths[i - 1], lengths[i]))
            start[n] = start[n - 1] + 4 * lengths[n - 1]
        self.lengths = lengths
        self.start = start

    @classmethod
    def from_db(cls, db) -> "PositionMapper":
        return cls(db.lengths)

    @property
    def extra_start(self) -> int:
        """First flat coordinate beyond all sequence spans
        (PositionMapper::extraStart)."""
        return int(self.start[-1]) if len(self.lengths) else 0

    def dual_to_single(self, ref_idx, pos) -> np.ndarray:
        """Vectorized (signed 1-based idx, pos) -> flat coord; idx 0 -> 0."""
        ref_idx = np.asarray(ref_idx, dtype=np.int64)
        pos = np.asarray(pos, dtype=np.int64)
        idx = np.abs(ref_idx) - 1
        safe = np.where(ref_idx == 0, 0, idx)
        offset = np.where(ref_idx > 0, 0, 2 * self.lengths[safe])
        out = self.start[safe] + offset + pos
        return np.where(ref_idx == 0, 0, out)

    def single_to_dual(self, flat) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized flat coord -> (signed 1-based idx, pos); 0 -> (0, 0).

        Mirrors PositionMapper::singleToDual: upper_bound over start[], step
        back one unless at begin, subtract; offsets past 2*len flip to the
        reverse-complement span.
        """
        flat = np.asarray(flat, dtype=np.int64)
        scalar = flat.ndim == 0
        flat = np.atleast_1d(flat)
        # upper_bound == searchsorted(side='right'); prev() unless at begin
        it = np.searchsorted(self.start, flat, side="right")
        it = np.maximum(it - 1, 0)
        idx = it
        offset = flat - self.start[idx]
        size2 = 2 * self.lengths[np.minimum(idx, len(self.lengths) - 1)] \
            if len(self.lengths) else np.zeros_like(idx)
        rev = offset >= size2
        out_idx = np.where(rev, -(idx + 1), idx + 1)
        out_pos = np.where(rev, offset - size2, offset)
        out_idx = np.where(flat == 0, 0, out_idx)
        out_pos = np.where(flat == 0, 0, out_pos)
        if scalar:
            return int(out_idx[0]), int(out_pos[0])
        return out_idx, out_pos

    def seq_size(self, ref_idx) -> np.ndarray:
        """Length of the sequence a signed index refers to; 0 for idx 0."""
        ref_idx = np.asarray(ref_idx, dtype=np.int64)
        scalar = ref_idx.ndim == 0
        ref_idx = np.atleast_1d(ref_idx)
        idx = np.abs(ref_idx) - 1
        safe = np.where(ref_idx == 0, 0, idx)
        out = np.where(ref_idx == 0, 0,
                       self.lengths[safe] if len(self.lengths)
                       else np.zeros_like(safe))
        return int(out[0]) if scalar else out
