"""K-mer encoding on the host.

Counterpart of the numpy half of ``aligngraph2_tpu/ops/kmer.py``
(``kmer_codes_np``, ``revcomp_code_np``, ``code_to_str``): big-endian
rolling 2-bit codes, A=0 C=1 G=2 T=3, non-ACGT treated as A.  The device
k-mer counter and the solid-set cutoff come with the slice that ports
stage 1.
"""

from __future__ import annotations

import numpy as np


def kmer_codes_np(codes: np.ndarray, k: int) -> np.ndarray:
    """Host: uint8 base codes -> int64 k-mer codes (length n-k+1; empty if
    n < k)."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=np.int64)
    c = codes.astype(np.int64)
    out = np.zeros(n - k + 1, dtype=np.int64)
    for j in range(k):
        out = (out << 2) | c[j:n - k + 1 + j]
    return out


def revcomp_code_np(code: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of 2-bit codes (host utility)."""
    code = np.asarray(code, dtype=np.int64)
    out = np.zeros_like(code)
    c = code.copy()
    for _ in range(k):
        out = (out << 2) | (3 - (c & 3))
        c >>= 2
    return out


def code_to_str(code: int, k: int) -> str:
    """Code -> k-mer string (KmerHelper::code2Kmer)."""
    table = "ACGT"
    out = []
    for _ in range(k):
        out.append(table[code & 3])
        code >>= 2
    return "".join(reversed(out))
