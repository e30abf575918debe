"""In-memory sequence database over flat numpy code arrays.

Copy of ``aligngraph2_tpu/io/seqdb.py``.

Replaces the reference's CompressedSeq / SeqInf / AutoSeqDatabase
(AlignGraph2 PAGraph/src/tools/seq/): sequences are stored as a single
concatenated ``uint8`` array of 2-bit base codes (A=0, C=1, G=2, T=3,
anything else = 0/A, matching CompressedSeq.cpp:8-38 and KmerHelper.hpp
acgt()), with per-sequence offsets, lengths, and a name->id map.  The flat
layout is what feeds padded device tensors; 4x bit-packing happens only at
the device boundary where it pays.
"""

from __future__ import annotations

import numpy as np
from typing import Dict, Iterable, List, Tuple

# base -> code lookup over all 256 byte values; non-ACGT maps to 0 (== 'A')
_ENC = np.zeros(256, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    _ENC[ord(ch)] = i
    _ENC[ord(ch.lower())] = i

_DEC = np.frombuffer(b"ACGT", dtype=np.uint8)
_DEC_LOWER = np.frombuffer(b"acgt", dtype=np.uint8)


def encode_seq(seq: str) -> np.ndarray:
    """ASCII string -> uint8 codes in {0,1,2,3}."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC[raw]


def decode_seq(codes: np.ndarray, lower: bool = False) -> str:
    table = _DEC_LOWER if lower else _DEC
    return table[codes].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space: complement == 3 - code."""
    return (3 - codes)[::-1]


class SeqDatabase:
    """Named sequences over one flat code array.

    Mirrors ISeqDatabase<SeqInf> (AlignGraph2 PAGraph/src/tools/seq/
    ISeqDatabase.hpp): integer ids in insertion order, name lookup, forward
    and reverse-complement decode, random base access.
    """

    NOT_FOUND = -1

    def __init__(self, records: Iterable[Tuple[str, str]] = ()):  # (name, seq)
        names: List[str] = []
        arrs: List[np.ndarray] = []
        for name, seq in records:
            names.append(name)
            arrs.append(encode_seq(seq))
        self.names: List[str] = names
        self.lengths = np.array([len(a) for a in arrs], dtype=np.int64)
        self.offsets = np.zeros(len(arrs) + 1, dtype=np.int64)
        np.cumsum(self.lengths, out=self.offsets[1:])
        self.codes = (np.concatenate(arrs) if arrs
                      else np.zeros(0, dtype=np.uint8))
        self._name_to_id: Dict[str, int] = {n: i for i, n in enumerate(names)}

    @classmethod
    def from_file(cls, path: str, use_native: bool = True) -> "SeqDatabase":
        if use_native:
            from .native import load_seqs_native
            loaded = load_seqs_native(path)
            if loaded is not None:
                return cls.from_arrays(*loaded)
        from .fasta import read_seqs
        return cls(read_seqs(path))

    @classmethod
    def from_arrays(cls, codes: np.ndarray, offsets: np.ndarray,
                    names) -> "SeqDatabase":
        db = cls()
        db.codes = codes
        db.offsets = np.asarray(offsets, dtype=np.int64)
        db.lengths = np.diff(db.offsets)
        db.names = list(names)
        db._name_to_id = {n: i for i, n in enumerate(db.names)}
        return db

    def subset(self, ids) -> "SeqDatabase":
        """New database holding the given sequence ids (insertion order =
        the given order) by slicing the flat code array — no per-read
        decode/encode round trip (the reference's per-group splitting
        copies files; re-decoding every read per group is O(reads x
        groups) at genome scale)."""
        ids = np.asarray(list(ids), dtype=np.int64)
        lengths = self.lengths[ids]
        offsets = np.zeros(len(ids) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        codes = np.empty(int(offsets[-1]), dtype=np.uint8)
        for row, i in enumerate(ids):
            codes[offsets[row]:offsets[row + 1]] = \
                self.codes[self.offsets[i]:self.offsets[i + 1]]
        return SeqDatabase.from_arrays(codes, offsets,
                                       [self.names[i] for i in ids])

    def subset_by_names(self, names) -> "SeqDatabase":
        """subset() by name set, preserving this database's id order."""
        wanted = set(names)
        return self.subset(i for i, n in enumerate(self.names)
                           if n in wanted)

    def __len__(self) -> int:
        return len(self.names)

    def size(self, idx: int) -> int:
        return int(self.lengths[idx])

    def name(self, idx: int) -> str:
        return self.names[idx]

    def seq_id(self, name: str) -> int:
        return self._name_to_id.get(name, self.NOT_FOUND)

    def contains(self, name: str) -> bool:
        return name in self._name_to_id

    def get_codes(self, idx: int, forward: bool = True) -> np.ndarray:
        a = self.codes[self.offsets[idx]:self.offsets[idx + 1]]
        return a if forward else revcomp_codes(a)

    def get_str(self, idx: int, forward: bool = True) -> str:
        return decode_seq(self.get_codes(idx, forward))

    def base_at(self, idx: int, pos: int, forward: bool = True) -> int:
        """Code of base at pos in the given orientation; 0 if out of range
        (CompressedSeq::baseAt returns 'N' out of range; callers only use
        in-range positions, we clamp to 0/'A' like the encoder does)."""
        n = self.size(idx)
        if pos < 0 or pos >= n:
            return 0
        if forward:
            return int(self.codes[self.offsets[idx] + pos])
        return 3 - int(self.codes[self.offsets[idx] + (n - 1 - pos)])

    def records(self) -> Iterable[Tuple[str, str]]:
        for i in range(len(self)):
            yield self.names[i], self.get_str(i)

    # --- padded batch views for device transfer -------------------------

    def padded_batch(self, ids: np.ndarray, max_len: int,
                     forward: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """(B, max_len) uint8 code matrix (pad=0) + (B,) lengths."""
        ids = np.asarray(ids, dtype=np.int64)
        out = np.zeros((len(ids), max_len), dtype=np.uint8)
        lens = np.minimum(self.lengths[ids], max_len).astype(np.int32)
        for row, (i, ln) in enumerate(zip(ids, lens)):
            out[row, :ln] = self.get_codes(int(i), forward)[:ln]
        return out, lens
