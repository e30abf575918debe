"""Pipeline configuration.

Counterpart of ``aligngraph2_tpu/config.py``.  ``AlignerConfig``,
``GraphConfig``, ``PreProcessConfig`` and ``ConsensusConfig`` are field-
for-field copies, so ``AlignerConfig(**dataclasses.asdict(jax_cfg))``
builds the same configuration on this side.  ``RuntimeConfig`` keeps the
mesh fields (``data_axis``, ``block_axis``, ``sharded_align``,
``block_parallel``; ``parallel/mesh.py``) and gains ``device`` and
``plain``, which the driver hands to every aligner it builds.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

# the band widths the CUDA kernels take (ops/banded_dp.py and
# ops/banded_static.py): band_width a power of two in this range; the CPU
# takes any width
BAND_WIDTH_MIN, BAND_WIDTH_MAX = 16, 4096


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


@dataclass
class GraphConfig:
    """Positional A-Bruijn graph + traversal knobs.

    Defaults mirror the reference's driver defaults
    (AlignGraph2 AlignGraph2.py:25-46) and the constants hard-coded in
    pagraph.cpp run2() (AlignGraph2 PAGraph/src/main/pagraph.cpp:110-125).
    """

    k: int = 14                     # graph k-mer size [4-15]
    solid_threshold: float = 0.2    # top mass fraction of 4^k table kept solid
                                    # (kmer_counter.cpp:58-77)
    epsilon: int = 10               # position-join distance [5-100]
    min_len: int = 50               # minimum path length for traversal
    cov_filter: int = 2             # coverage filter -v
    # hard-coded in pagraph.cpp:110-125.  The reference also declares
    # ctgToRefTopK / ctgToRefRatio / ctgToRefTotalRatio / ctgToRefMinLen /
    # innerSample there, but they are dead upstream too: the ctg->ref
    # filters are commented out in Aligner::simpleAlign
    # (Aligner.cpp:112-151,174-176), _ctgToRefTopK is set-but-never-read
    # (Aligner.cpp:269-271), and innerSample is stored-but-never-used
    # (PositionProcessor.cpp:206-208) — so they are intentionally not
    # carried here.
    read_to_ctg_top_k: int = -1
    read_to_ref_top_k: int = -1
    outer_sample: int = 3
    read_to_ctg_ratio: float = 0.35
    read_to_ref_ratio: float = 0.10
    error_rate: float = 0.15
    start_split: float = 0.90
    # traversal deviation is epsilon * 2 (pagraph.cpp:250 'posError * 2')
    travel_top_k: int = 8           # parallel greedy walks per step


@dataclass
class PreProcessConfig:
    """Contig-to-reference grouping (reference pre_process defaults:
    AlignGraph2 PAGraph/src/main/pre_process.cpp:212-238)."""

    group_top_k: int = 1            # top-K (ref,orient) per contig
    group_cover_ratio: float = 0.15 # min covered fraction of contig


@dataclass
class ConsensusConfig:
    """Windowed POA consensus (reference pa_cns defaults:
    AlignGraph2 PAGraph/src/main/pa_cns.cpp:23-47 and the driver's
    part_len/top_k at AlignGraph2.py:494-496)."""

    window: int = 10_000            # -a / part_len: backbone window size
    top_k: int = 3000               # alignments kept per window
    alpha: int = 250                # weight cap for score-proportional weights
    min_weight: int = 0             # consensus min base weight


@dataclass
class RuntimeConfig:
    """Host/device execution knobs."""

    threads: int = 16               # host worker threads for IO-bound stages
    data_axis: str = "data"         # mesh axis: reads data-parallel
    block_axis: str = "block"       # mesh axis: genome-block sharding
    sharded_align: bool | None = None  # run alignment under the device mesh
                                    # (None = auto: sharded iff the device
                                    # is cuda and more than one card is
                                    # present)
    block_parallel: int | None = None  # devices on the block axis
                                    # (None = auto, see parallel/mesh.py)
    progress: bool = True           # console progress bar on long loops
                                    # (MyTools::progress equivalent)
    profile_dir: Optional[str] = None  # write a torch.profiler trace here
                                    # (replaces the reference's hand-rolled
                                    # timing/RSS prints)
    device: str = "cuda"            # where the aligner stages run: "cuda"
                                    # (the static band's kernels; raises
                                    # without a card) or "cpu" (the
                                    # adaptive band, the JAX package's CPU
                                    # records)
    plain: bool = False             # static band through the plain torch
                                    # versions of the kernels (the
                                    # reference the card is held against)


@dataclass
class PipelineConfig:
    aligner: AlignerConfig = field(default_factory=AlignerConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    preprocess: PreProcessConfig = field(default_factory=PreProcessConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def validate(self) -> None:
        """Range checks mirroring AlignGraph2 AlignGraph2.py:89-119."""
        g, a, c = self.graph, self.aligner, self.consensus
        if not 4 <= g.k <= 15:
            raise ValueError("Size of k-mer must be [4-15]")
        if not 0.0 <= a.alpha <= 1.0:
            raise ValueError("Lower bound of k-mer scoring must be [0-1]")
        if not 1.0 <= a.beta:
            raise ValueError("Upper bound of k-mer scoring must be >= 1")
        if not 0.0 <= a.delta <= 1.0:
            raise ValueError("threshold for alignment scoring must be [0-1]")
        if a.candidate_prune != -1.0 and not 0.0 <= a.candidate_prune <= 1.0:
            raise ValueError("candidate_prune must be [0-1] or -1 (auto)")
        if not 8 <= a.seed_k <= 16:
            raise ValueError("Aligner seed_k must be [8-16]")
        if not 8 <= a.ref_seed_k <= 16:
            raise ValueError("Aligner ref_seed_k must be [8-16]")
        if not a.seed_k_max <= 16:
            raise ValueError("seed_k_max must be <= 16")
        if not 1 <= g.cov_filter:
            raise ValueError("coverage to filter alignments must be >= 1")
        if not 5 <= g.epsilon <= 100:
            raise ValueError("Distance to join two vertices must be [5-100]")
        if not 0 <= g.min_len:
            raise ValueError("Minimum path length must not be negative")
        if not 100 <= c.window <= 100_000:
            raise ValueError("Size of long read blocks must be [100-100000]")
        if not 0 <= self.runtime.threads:
            raise ValueError("Thread number must not be negative")
        if self.runtime.device not in ("cuda", "cpu"):
            raise ValueError("device must be cuda or cpu")
        W = a.band_width
        if self.runtime.device == "cuda" and not (
                BAND_WIDTH_MIN <= W <= BAND_WIDTH_MAX and W & (W - 1) == 0):
            raise ValueError(
                f"band_width {W}: on cuda it must be a power of two from "
                f"{BAND_WIDTH_MIN} to {BAND_WIDTH_MAX} (the band kernels' "
                "widths)")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        raw = json.loads(text)
        return cls(
            aligner=AlignerConfig(**raw.get("aligner", {})),
            graph=GraphConfig(**raw.get("graph", {})),
            preprocess=PreProcessConfig(**raw.get("preprocess", {})),
            consensus=ConsensusConfig(**raw.get("consensus", {})),
            runtime=RuntimeConfig(**raw.get("runtime", {})),
        )
