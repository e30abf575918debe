"""Streaming FASTA/FASTQ readers and writers.

Copy of ``aligngraph2_tpu/io/fasta.py``.

Behavioral contract mirrors the reference loaders
(AlignGraph2 PAGraph/src/tools/seq/SeqHelper.cpp:8-99): format is
auto-detected from the first byte ('@' = FASTQ, '>' or ';' = FASTA); FASTA
records may span multiple lines; FASTQ records are strictly 4 lines.  Names
are the first whitespace-delimited token after the marker character
(AlignGraph2 PAGraph/src/tools/seq/AutoSeqDatabase.cpp:9-22).
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple, Iterable

LINE_WIDTH = 70  # reference emits 70-col FASTA (PAssembly.cpp lineSize = 70)


def detect_format(path: str) -> str:
    """'fasta' | 'fastq' | 'unknown' from the first byte (SeqHelper.cpp:76-99)."""
    with open(path, "rb") as f:
        first = f.read(1)
    if first == b"@":
        return "fastq"
    if first in (b">", b";"):
        return "fasta"
    return "unknown"


def _first_token(header: str) -> str:
    return header.split()[0] if header.split() else ""


def iter_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, seq).  Multi-line sequences are concatenated."""
    name = None
    chunks: list[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">") or line.startswith(";"):
                if name is not None:
                    yield name, "".join(chunks)
                name = _first_token(line[1:])
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def iter_fastq(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, seq) from 4-line FASTQ records."""
    with open(path, "r") as f:
        while True:
            l1 = f.readline()
            if not l1:
                break
            l2 = f.readline()
            l3 = f.readline()
            l4 = f.readline()
            if not l4 and not l2:
                break
            yield _first_token(l1[1:].rstrip("\n")), l2.rstrip("\n")


def read_seqs(path: str) -> Iterator[Tuple[str, str]]:
    fmt = detect_format(path)
    if fmt == "fastq":
        return iter_fastq(path)
    return iter_fasta(path)


def write_fasta(path: str, records: Iterable[Tuple[str, str]],
                line_width: int = LINE_WIDTH) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                f.write(seq[i:i + line_width])
                f.write("\n")


def write_text_if_changed(path: str, text: str) -> bool:
    """Write ``text`` to ``path`` only if the content differs.

    Leaving identical files untouched preserves their mtimes, which keeps
    downstream StageCache CHECK records valid across reruns (the cache is
    (size, mtime)-addressed, pipeline/cache.py).  Returns True if written.
    """
    try:
        with open(path, "r") as f:
            if f.read() == text:
                return False
    except OSError:
        pass
    with open(path, "w") as f:
        f.write(text)
    return True


def render_fasta(records: Iterable[Tuple[str, str]],
                 line_width: int = LINE_WIDTH) -> str:
    out: list[str] = []
    for name, seq in records:
        out.append(f">{name}\n")
        for i in range(0, len(seq), line_width):
            out.append(seq[i:i + line_width])
            out.append("\n")
    return "".join(out)


def write_fasta_if_changed(path: str, records: Iterable[Tuple[str, str]],
                           line_width: int = LINE_WIDTH) -> bool:
    """write_fasta preserving mtime when content is unchanged (see
    write_text_if_changed)."""
    return write_text_if_changed(path, render_fasta(records, line_width))


def write_fastq(path: str, records: Iterable[Tuple[str, str]]) -> None:
    """Write FASTQ with dummy quality (reference long2ref fakes quality too,
    script/long2ref.py:30)."""
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f"@{name}\n{seq}\n+\n{'!' * len(seq)}\n")


def concat_files(out_path: str, *in_paths: str) -> None:
    """Binary concatenation (reference script/cns_helper.py:merge_files)."""
    with open(out_path, "wb") as out:
        for p in in_paths:
            if not os.path.exists(p):
                continue
            with open(p, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)
