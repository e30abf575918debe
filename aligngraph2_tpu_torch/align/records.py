"""Alignment records and the 3-line ".ref" interchange format.

Copy of ``aligngraph2_tpu/align/records.py``: the ``.ref`` text format is
identical, so each package reads the records the other writes.

The on-disk format is byte-compatible with the reference's stage handoff
files (AlignGraph2 PAGraph/src/tools/align/AlignmentHelper.cpp:10-70):

    line1: query ref F/R score qb qe qsize rb re rsize
    line2: gapped query string (aligned strand)
    line3: gapped target string (forward strand)

Header coordinates are forward-strand, end-exclusive.  For 'R' records the
gapped query string is the reverse-complement strand of the query walked
forward (the MECAT convention the reference replays in Aligner.tcc).

In memory an alignment carries the two boolean diff masks derived exactly
like ParseAlignTools::parseDiff (AlignGraph2 PAGraph/src/tools/align/
ParseAlignTools.cpp:7-26): per alignment column,
    qdiff = query is '-' OR mismatch;  rdiff = target is '-' OR mismatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import numpy as np


def parse_diff(qstr: str, tstr: str) -> Tuple[np.ndarray, np.ndarray]:
    """Gapped string pair -> (qdiff, rdiff) boolean masks."""
    q = np.frombuffer(qstr.encode(), dtype=np.uint8)
    t = np.frombuffer(tstr.encode(), dtype=np.uint8)
    qgap = q == ord("-")
    tgap = t == ord("-")
    mismatch = (~qgap) & (~tgap) & (q != t)
    return (qgap | mismatch), (tgap | mismatch)


def exact_align_pairs(qbegin: int, rbegin: int, forward: bool,
                      qdiff: np.ndarray, rdiff: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Replay diff masks into per-column (query_pos, target_pos) pairs.

    Vectorized equivalent of ParseAlignTools::exactAlign
    (AlignGraph2 PAGraph/src/tools/align/ParseAlignTools.tcc:44-70):
    emits a pair for match, mismatch and target-gap columns (query advances),
    but NOT for query-gap columns (only target advances).  ``forward=False``
    walks the columns in reverse order (the caller's target is
    reverse-complemented) while both coordinates still increase from the
    given begins.
    """
    if len(qdiff) == 0:
        return (np.zeros(0, dtype=np.int64),) * 2
    qd = np.asarray(qdiff, dtype=bool)
    rd = np.asarray(rdiff, dtype=bool)
    if not forward:
        qd = qd[::-1]
        rd = rd[::-1]
    # per column: does query coord advance? does target coord advance?
    q_gap_only = qd & ~rd          # query gap: target advances, no emission
    r_gap_only = ~qd & rd          # target gap: query advances, emission
    both = ~(qd ^ rd)              # match or mismatch: both advance, emission
    q_adv = both | r_gap_only
    r_adv = both | q_gap_only
    q_pos = qbegin + np.cumsum(q_adv) - q_adv  # position BEFORE advancing
    r_pos = rbegin + np.cumsum(r_adv) - r_adv
    emit = both | r_gap_only
    return q_pos[emit].astype(np.int64), r_pos[emit].astype(np.int64)


@dataclass
class Alignment:
    query_name: str
    ref_name: str
    forward: bool
    score: int
    qb: int           # forward-strand query interval [qb, qe)
    qe: int
    qsize: int
    rb: int           # forward-strand target interval [rb, re)
    re: int
    rsize: int
    qstr: str = ""    # gapped query (aligned strand); may be empty if only
    tstr: str = ""    # masks are carried
    qdiff: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    rdiff: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))

    def __post_init__(self):
        if self.qstr and len(self.qdiff) == 0:
            self.qdiff, self.rdiff = parse_diff(self.qstr, self.tstr)

    def sort_key(self):
        """Reference AlignInf ordering is score-descending
        (AlignInf::operator< compares score with '>')."""
        return -self.score


class AlignmentSet:
    """A list of alignments with .ref file IO."""

    def __init__(self, alignments: List[Alignment] | None = None):
        self.alignments: List[Alignment] = alignments or []

    def __len__(self):
        return len(self.alignments)

    def __iter__(self) -> Iterator[Alignment]:
        return iter(self.alignments)

    def __getitem__(self, i) -> Alignment:
        return self.alignments[i]

    def append(self, a: Alignment) -> None:
        self.alignments.append(a)

    def sort_by_score(self) -> None:
        self.alignments.sort(key=Alignment.sort_key)

    def write_ref_file(self, f) -> None:
        for a in self.alignments:
            f.write(f"{a.query_name}\t{a.ref_name}\t"
                    f"{'F' if a.forward else 'R'}\t{a.score}\t"
                    f"{a.qb}\t{a.qe}\t{a.qsize}\t"
                    f"{a.rb}\t{a.re}\t{a.rsize}\n")
            f.write(a.qstr + "\n")
            f.write(a.tstr + "\n")

    def write_ref(self, path: str) -> None:
        with open(path, "w") as f:
            self.write_ref_file(f)

    def to_ref_text(self) -> str:
        """The 3-line format as one string (the multi-host interchange,
        parallel/distributed.py gather_alignments)."""
        import io
        buf = io.StringIO()
        self.write_ref_file(buf)
        return buf.getvalue()

    @classmethod
    def from_ref_text(cls, text: str, keep_strings: bool = True
                      ) -> "AlignmentSet":
        import io
        return cls.read_ref_file(io.StringIO(text), keep_strings)

    @classmethod
    def read_ref(cls, path: str, keep_strings: bool = True
                 ) -> "AlignmentSet":
        """Parse the 3-line format.  Records whose header fails to parse are
        kept only as far as the reference keeps them (MecatAlignDatabase
        feeds every record triple through; a failed header yields an empty
        record there — we drop them, matching the driver's filter step
        script/filter.py which drops malformed records before this point)."""
        with open(path, "r", errors="ignore") as f:
            return cls.read_ref_file(f, keep_strings)

    @classmethod
    def read_ref_file(cls, f, keep_strings: bool = True
                      ) -> "AlignmentSet":
        out = cls()
        while True:
            l1 = f.readline()
            if not l1:
                break
            l2 = f.readline().rstrip("\n")
            l3 = f.readline().rstrip("\n")
            parts = l1.split()
            if len(parts) < 9 or len(l2) != len(l3):
                continue
            try:
                if len(parts) >= 10:
                    score = (int(float(parts[3]))
                             if parts[3] != "NULL" else 0)
                    qsize, rsize = int(parts[6]), int(parts[9])
                else:
                    # 9-field ctg->ref variant: the reference's
                    # MummerAlignDatabaseV2.cpp:21-24 reads exactly
                    # 9 fields (score & sizes slots ignored) and sets
                    # score = queryEnd - queryBegin (aligned length,
                    # MummerAlignDatabaseV2.cpp:38).
                    score = int(parts[5]) - int(parts[4])
                    qsize, rsize = 0, 0
                a = Alignment(
                    query_name=parts[0], ref_name=parts[1],
                    forward=parts[2] == "F", score=score,
                    qb=int(parts[4]), qe=int(parts[5]),
                    qsize=qsize, rb=int(parts[7]),
                    re=int(parts[8]), rsize=rsize,
                    qstr=l2 if keep_strings else "",
                    tstr=l3 if keep_strings else "")
                if not keep_strings:
                    a.qdiff, a.rdiff = parse_diff(l2, l3)
            except ValueError:
                continue
            out.append(a)
        return out
