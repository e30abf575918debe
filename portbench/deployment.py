"""A deployment's sequences, made from its configuration file and a seed.

The benchmark makes these once a run and hands the same arrays to the
program (as its ``SeqDatabase``) and to the plain reference."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import synth


class Seqs(NamedTuple):
    """Named sequences over one flat array of base codes."""
    codes: np.ndarray     # uint8, A=0 C=1 G=2 T=3
    offsets: np.ndarray   # (n + 1,) int64
    names: list

    def __len__(self):
        return len(self.names)

    def size(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def get(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i]:self.offsets[i + 1]]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def seqs(arrays, names) -> Seqs:
    offsets = np.zeros(len(arrays) + 1, np.int64)
    np.cumsum([len(a) for a in arrays], out=offsets[1:])
    codes = (np.concatenate(arrays) if arrays else np.zeros(0, np.uint8))
    return Seqs(codes, offsets, list(names))


def build(config: dict, seed: int, coverage: float, parts) -> dict:
    """The deployment's ``parts`` ("genome", "similar", "contigs",
    "reads") as Seqs, at ``coverage`` for the reads."""
    g = config["genome"]
    names = [c[0] for c in g["chromosomes"]]
    lengths = [int(c[1]) for c in g["chromosomes"]]
    chroms = synth.genome_with_repeats(synth.stream(seed, synth.GENOME),
                                       lengths, **g["repeats"],
                                       size_rng=synth.sizes(synth.GENOME))
    out = {}
    if "genome" in parts:
        out["genome"] = seqs(chroms, names)
    if "similar" in parts:
        out["similar"] = seqs(synth.similar_genome(
            synth.stream(seed, synth.SIMILAR), chroms,
            config["similar"]["divergence"]), names)
    if "contigs" in parts:
        c = config["contigs"]
        ctgs = synth.draft_contigs(synth.stream(seed, synth.CONTIGS),
                                   chroms[0], c["count"], c["gap"], c["err"])
        out["contigs"] = seqs(ctgs, [f"ctg{j}" for j in range(len(ctgs))])
    if "reads" in parts:
        r = config["reads"]
        codes, offsets = synth.pacbio_reads(
            synth.stream(seed, synth.READS), chroms, coverage,
            mean_len=r["mean_len"], err=r["err"], chimera=r["chimera"],
            sigma=r["sigma"], size_rng=synth.sizes(synth.READS))
        out["reads"] = Seqs(codes, offsets,
                            [str(i + 1) for i in range(len(offsets) - 1)])
    return out
