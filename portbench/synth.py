"""The deployment generator: a genome of one or more chromosomes with
planted repeats, a similar genome, PacBio CLR reads and draft contigs, all
made from one seed.

A frozen copy of the generators of ``tests/synth.py`` (``mutate``,
``random_genome_with_repeats``, ``sample_reads_pacbio``, the contig layout
of ``make_dataset``), rewritten over uint8 base codes (A=0, C=1, G=2, T=3)
so no string is encoded or decoded, with two additions:

  * several chromosomes: repeat families are shared by the whole genome,
    and a read segment is drawn from a chromosome picked in proportion to
    its length;
  * the reads are mutated in groups, one vectorised call a group, which
    keeps a 240 Mb read set to a few seconds.

Each part draws from its own stream (``numpy.random.default_rng([seed,
part])``), so a part is the same whether or not the others are made.
Seeds may be any non-negative integer, 2**31 and above included.

The sizes are not the seed's: the read lengths, which reads are chimeras
and the repeat units' lengths come from one fixed stream
(``sizes()``), so every seed asks for the same work and a seed changes
the sequence, where each read lies, its strand and errors, and the order
of the reads within each block of ``ORDER_BLOCK``.  (Drawn from the
seed, the sizes moved a window's reads a second by some 10% from seed
to seed: the few reads past 32 kb each cost an extender call of their
own.)
"""

from __future__ import annotations

import numpy as np

GENOME, SIMILAR, READS, CONTIGS = 0, 1, 2, 3
READ_GROUP_BASES = 1 << 24   # raw bases a vectorised mutate call takes
ORDER_BLOCK = 1024           # reads a seed reorders among themselves


def stream(seed: int, part: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), part])


def sizes(part: int) -> np.random.Generator:
    """The fixed stream of a part's sizes, the same for every seed."""
    return np.random.default_rng([0, 1 << 20, part])


def random_codes(rng: np.random.Generator, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes)[::-1]


def _mutate_slots(rng, codes, sub, ins, dele):
    """The mutation of ``tests/synth.py::mutate`` on codes: each base is
    deleted at ``dele``, else preceded by a random inserted base at
    ``ins``, else substituted by another base at ``sub``.  Returns the
    mutated codes and, for each input base, the output slots taken before
    it (so a segment [s, e) of the input becomes [before[s], before[e]))."""
    n = len(codes)
    r = rng.random(n, dtype=np.float32)
    keep = r >= dele
    is_ins = keep & (r < dele + ins)
    is_sub = (r >= dele + ins) & (r < dele + ins + sub)
    c = codes.copy()
    at = np.flatnonzero(is_sub)
    c[at] = (c[at] + 1 + rng.integers(0, 3, len(at), dtype=np.uint8)) % 4
    before = np.zeros(n + 1, np.int64)
    np.cumsum(keep.astype(np.int8) + is_ins, out=before[1:])
    out = np.empty(int(before[-1]), np.uint8)
    at = np.flatnonzero(keep)
    out[before[at + 1] - 1] = c[at]
    at = np.flatnonzero(is_ins)
    out[before[at + 1] - 2] = rng.integers(0, 4, len(at), dtype=np.uint8)
    return out, before


def mutate(rng, codes, sub=0.01, ins=0.002, dele=0.002) -> np.ndarray:
    """Substitutions, insertions (a random base before a kept base) and
    deletions at the given rates."""
    return _mutate_slots(rng, codes, sub, ins, dele)[0]


def genome_with_repeats(rng, lengths, repeat_frac=0.15, n_families=5,
                        unit_len=(500, 5000), copy_div=0.02,
                        size_rng=None) -> list:
    """One random chromosome per length, with copies of ``n_families``
    shared repeat units (mutated by ``copy_div``, either strand) pasted at
    random places until ``repeat_frac`` of each chromosome is repeat.  The
    units' lengths come from ``size_rng`` (default: ``rng``)."""
    size_rng = rng if size_rng is None else size_rng
    chroms = [random_codes(rng, int(n)).copy() for n in lengths]
    units = [random_codes(rng, int(size_rng.integers(unit_len[0],
                                                      unit_len[1] + 1)))
             for _ in range(n_families)]
    for base in chroms:
        length = len(base)
        placed = 0
        target = int(length * repeat_frac)
        while placed < target:
            u = units[int(rng.integers(0, n_families))]
            c = mutate(rng, u, sub=copy_div, ins=copy_div / 4,
                       dele=copy_div / 4)
            if rng.random() < 0.5:
                c = revcomp(c)
            if len(c) >= length:
                break
            pos = int(rng.integers(0, length - len(c)))
            base[pos:pos + len(c)] = c
            placed += len(c)
    return chroms


def similar_genome(rng, chroms, divergence) -> list:
    """The similar genome, one record per chromosome: substitutions at
    ``divergence``, insertions and deletions at a quarter of it each."""
    return [mutate(rng, c, sub=divergence, ins=divergence / 4,
                   dele=divergence / 4) for c in chroms]


def pacbio_reads(rng, chroms, coverage, mean_len=9000, err=0.13,
                 chimera=0.02, sigma=0.55, size_rng=None):
    """PacBio CLR reads (``sample_reads_pacbio``): log-normal lengths of
    mean ``mean_len`` and shape ``sigma`` clipped to [500, the
    chromosome], either strand, a ``chimera`` share joined from two
    segments, errors at ``err`` split ins : del : sub = 3 : 2 : 1.  The
    lengths and the chimeras come from ``size_rng`` (default: ``rng``);
    ``rng`` reorders the reads within each block of ORDER_BLOCK.  Returns
    (codes, offsets) of the reads in order; read i is named str(i + 1)."""
    size_rng = rng if size_rng is None else size_rng
    sub, ins, dele = err / 6, err / 2, err / 3
    mu = float(np.log(mean_len)) - sigma * sigma / 2
    lens = np.array([len(c) for c in chroms], np.int64)
    cum = np.cumsum(lens) / lens.sum()
    n_bases = int(lens.sum() * coverage)

    def segment(ln):
        g = chroms[int(np.searchsorted(cum, rng.random(), side="right"))
                   if len(chroms) > 1 else 0]
        ln = min(ln, len(g))
        start = int(rng.integers(0, len(g) - ln + 1))
        seq = g[start:start + ln]
        return revcomp(seq) if rng.random() < 0.5 else seq

    raws = []
    total = 0
    longest = int(lens.max())
    while total < n_bases:
        ln = int(np.clip(size_rng.lognormal(mu, sigma), 500, longest))
        if size_rng.random() < chimera:
            l1 = max(250, ln // 2)
            raw = np.concatenate([segment(l1), segment(max(250, ln - l1))])
        else:
            raw = segment(ln)
        raws.append(raw)
        total += len(raw)
    n = len(raws)
    raws = [raws[i] for s in range(0, n, ORDER_BLOCK)
            for i in s + rng.permutation(min(ORDER_BLOCK, n - s))]
    outs, out_lens = [], []
    start = 0
    while start < n:
        end, group = start, 0
        while end < n and group < READ_GROUP_BASES:
            group += len(raws[end])
            end += 1
        bounds = np.zeros(end - start + 1, np.int64)
        np.cumsum([len(x) for x in raws[start:end]], out=bounds[1:])
        out, before = _mutate_slots(rng, np.concatenate(raws[start:end]),
                                    sub, ins, dele)
        outs.append(out)
        out_lens.extend(np.diff(before[bounds]).tolist())
        start = end
    codes = np.concatenate(outs) if outs else np.zeros(0, np.uint8)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(out_lens, out=offsets[1:])
    return codes, offsets


def draft_contigs(rng, genome, count, gap, err=0.005) -> list:
    """``count`` draft contigs over one chromosome (``make_dataset``'s
    layout): equal pieces with ``gap`` bases before, between and after
    them, each with light errors (substitutions at ``err``, insertions and
    deletions at half of it)."""
    piece = (len(genome) - (count + 1) * gap) // count
    out = []
    pos = gap
    for _ in range(count):
        out.append(mutate(rng, genome[pos:pos + piece], sub=err,
                          ins=err / 2, dele=err / 2))
        pos += piece + gap
    return out
