"""Aligner configuration.

Counterpart of ``aligngraph2_tpu/config.py``: ``AlignerConfig`` is a field-
for-field copy, so ``AlignerConfig(**dataclasses.asdict(jax_cfg))`` builds
the same configuration on this side.  The graph, pre-process, consensus,
runtime and pipeline configs come with the slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AlignerConfig:
    """Seed-extend aligner knobs (replaces mecat2ref / mecat2ref+ / nucmer).

    The reference invokes mecat2ref with ``-b 1`` (one volume) and mecat2ref+
    additionally with ``-l alpha -u beta -z block -y delta``
    (AlignGraph2 AlignGraph2.py:265-277).  The customized scoring of
    mecat2ref+ partitions the similar genome into blocks and clamps the k-mer
    scoring function to [alpha, beta] (README.md:43-51).
    """

    seed_k: int = 13                # seeding k-mer size (MECAT uses 13)
    ref_seed_k: int = 12            # seeding k for the read->SIMILAR-GENOME
                                    # stage only (the mecat2ref+ role):
                                    # divergence is the product's point
                                    # (README.md:5) and 13-mer survival
                                    # (0.8*0.88)^13 ~ 1% caps 20%-diverged
                                    # recall at ~0.43; k=12 lifts it to
                                    # 0.67 (k=11: 0.80) with NO
                                    # low-divergence regression — see
                                    # PARITY.md mecat2ref+ table
    seed_stride: int = 1            # query k-mer sampling stride for seeding
    ref_seed_rescue: bool = True    # two-level read->similar-genome
                                    # seeding: first pass at seed_k
                                    # (cheap), then re-seed ONLY the
                                    # reads with no alignment at
                                    # ref_seed_k (the diverged-locus
                                    # rescue).  Preserves the
                                    # diverged-recall contract — a read
                                    # whose best locus is diverged
                                    # fails the k=13 pass and gets the
                                    # k=12 treatment — at a fraction of
                                    # the small-seed noise cost
                                    # (G/4^12 hits/kmer for only the
                                    # unaligned tail).  Recall locked by
                                    # tests/test_aligner.py::
                                    # test_ref_seed_rescue_preserves_
                                    # diverged_recall
    seed_k_auto: bool = True        # grow seed_k with TARGET size so the
                                    # random-hit rate G/4^k stays flat —
                                    # per-read seeding cost was linear in
                                    # genome size at fixed k (the 50 Mb
                                    # superlinear aligner wall).  Applies
                                    # to same-species stages only; the
                                    # driver pins the similar-genome
                                    # stage to ref_seed_k (divergence
                                    # needs small seeds)
    seed_k_max: int = 15            # auto-scaling cap (prefix-table
                                    # index supports up to 16)
    seed_noise_rate: float = 0.125  # target random hits per query k-mer:
                                    # bump k while G/4^k exceeds this
                                    # (0.125 = the 5 Mb bench's regime at
                                    # k=13, so bench-scale runs are
                                    # unchanged)
    block_size: int = 200_000       # genome block size (bp) for the sharded
                                    # seed index (CLI -b, interpreted in kb:
                                    # the reference validates -b in [50-1000]
                                    # but never forwards it,
                                    # AlignGraph2.py:93-95; here it sets the
                                    # block-sharding granularity of the
                                    # multi-device seeding path)
    alpha: float = 0.5              # lower clamp of block k-mer score
    beta: float = 2.0               # upper clamp of block k-mer score
    delta: float = 0.9              # alignment score acceptance threshold
    max_candidates: int = 8         # candidate (block,strand) pairs per read
    min_block_hits: int = 4         # min seed hits for a candidate block
    candidate_prune: float = -1.0   # pre-extension prune: drop candidates
                                    # with seed hits < prune * the read's
                                    # best-candidate hits.  -1 = auto
                                    # (delta^2 — justified by the delta
                                    # output contract, see
                                    # ops/seedextend.py
                                    # _finalize_read_candidates); 0 = off
    band_width: int = 256           # DP band width (lanes); power of two
    match_score: int = 2
    mismatch_score: int = -4
    gap_score: int = -3             # linear gap penalty
    x_drop: int = 250               # stop a lane once its row frontier
                                    # drops more than this below its best
                                    # (0 = full NQ rows, no early exit);
                                    # 250 = ~83 consecutive gaps with no
                                    # recovery — far beyond PacBio indel
                                    # bursts, so real alignments never die
    min_aln_len: int = 200          # drop alignments shorter than this (bases)
    min_identity: float = 0.6       # identity floor for emitted alignments
    chunk_len: int = 10_000         # pseudo-read chunking for contig->ref
                                    # (reference: script/long2ref.py:10)
    batch_reads: int = 64           # reads per device batch (padded)
    max_read_len: int = 131_072     # reads longer than this are skipped by
                                    # the aligner (padding past this would
                                    # blow the DP stream budget; ultra-long
                                    # outliers add nothing at 2^17+ bp)

    @property
    def prune_ratio(self) -> float:
        """Effective pre-extension candidate prune (see candidate_prune)."""
        return (self.candidate_prune if self.candidate_prune >= 0
                else self.delta ** 2)
