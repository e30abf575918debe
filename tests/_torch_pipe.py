"""Run the JAX package's pipeline and the port's on the same inputs, each in
a directory of its own, and compare what they wrote.

Used by tests/test_torch_pipeline.py (legacy 6 kb dataset) and
tests/test_torch_pipeline_pacbio.py (PacBio 6 kb dataset).  The JAX run
takes its single-device aligner (``sharded_align=False``; the mesh is not
ported) and the port runs on the CPU, where its records equal the JAX
package's."""

from __future__ import annotations

import dataclasses
import filecmp
import os

# tests/test_pipeline.py small_cfg's values
SMALL = {"aligner": dict(band_width=128, min_aln_len=150, min_block_hits=3,
                         seed_k=11, delta=0.5, chunk_len=1500),
         "graph": dict(k=12, solid_threshold=0.05),
         "consensus": dict(window=2000, top_k=200),
         "runtime": dict(threads=2, progress=False)}

# what must exist and be equal: the five outputs, and in the working dir
# every .ref, the solid set, config.txt, coninfo and cor.fasta
OUTPUTS = ("final.fasta", "remainder.fasta", "exclude.fasta", "add.fasta",
           "connect_info.txt")
WORKING = ("working_dir/solid_kmer_set.bin",
           "working_dir/mecat/ctg/read_to_contig.ref",
           "working_dir/mecat/ref/read_to_ref.ref",
           "working_dir/mummer/ctg_to_ref.ref",
           "working_dir/input/p/config.txt",
           "working_dir/pagraph2/coninfo",
           "working_dir/cns/wrk/merge.ref",
           "working_dir/cns/output/cor.fasta")
# CHECK records each input's absolute path; metrics.json holds walls
NOT_COMPARED = ("CHECK", "metrics.json")


def small_cfg(pkg: str):
    """small_cfg's values as package ``pkg``'s PipelineConfig."""
    if pkg == "jax":
        from aligngraph2_tpu.config import PipelineConfig
        cfg = PipelineConfig()
        cfg.runtime.sharded_align = False
    else:
        from aligngraph2_tpu_torch.config import PipelineConfig
        cfg = PipelineConfig()
        cfg.runtime.device = "cpu"
    for part, values in SMALL.items():
        for key, val in values.items():
            setattr(getattr(cfg, part), key, val)
    return cfg


def jax_cfg_like(cfg):
    """The JAX package's PipelineConfig with the port config's values
    (single-device aligner, no mesh)."""
    from aligngraph2_tpu import config as jc
    return jc.PipelineConfig(
        aligner=jc.AlignerConfig(**dataclasses.asdict(cfg.aligner)),
        graph=jc.GraphConfig(**dataclasses.asdict(cfg.graph)),
        preprocess=jc.PreProcessConfig(**dataclasses.asdict(cfg.preprocess)),
        consensus=jc.ConsensusConfig(**dataclasses.asdict(cfg.consensus)),
        runtime=jc.RuntimeConfig(threads=cfg.runtime.threads,
                                 progress=cfg.runtime.progress,
                                 sharded_align=False))


def inputs(ds, d: str):
    """Paths of reads.fq, ctg.fa and genome.fa of dataset ``ds`` in ``d``,
    written on the first call only (the stage cache keys on mtimes)."""
    from aligngraph2_tpu_torch.io.fasta import write_fasta, write_fastq
    paths = tuple(os.path.join(d, n)
                  for n in ("reads.fq", "ctg.fa", "genome.fa"))
    if not os.path.exists(paths[0]):
        os.makedirs(d, exist_ok=True)
        write_fastq(paths[0], ds["reads"])
        write_fasta(paths[1], ds["contigs"])
        write_fasta(paths[2], ds["similar"])
    return paths


def run(pkg: str, ds, d: str, cfg=None, log=None):
    """Package ``pkg``'s run_pipeline on ``ds`` in directory ``d``, into
    ``d/out``."""
    if pkg == "jax":
        from aligngraph2_tpu.pipeline.driver import run_pipeline
    else:
        from aligngraph2_tpu_torch.pipeline.driver import run_pipeline
    return run_pipeline(*inputs(ds, d), os.path.join(d, "out"),
                        cfg or small_cfg(pkg), log=log or (lambda *a: None))


def files(out_dir: str) -> list:
    """Every file under ``out_dir`` that both packages must write alike,
    relative to it."""
    rel = []
    for root, _, names in os.walk(out_dir):
        for name in names:
            if name not in NOT_COMPARED:
                rel.append(os.path.relpath(os.path.join(root, name),
                                           out_dir))
    return sorted(rel)


def differing(want_dir: str, got_dir: str) -> list:
    """Files of ``want_dir`` that ``got_dir`` lacks or holds otherwise;
    asserts that the named outputs are among those compared."""
    rel = files(want_dir)
    assert set(OUTPUTS) | set(WORKING) <= set(rel), rel
    assert files(got_dir) == rel
    return [r for r in rel
            if not filecmp.cmp(os.path.join(want_dir, r),
                               os.path.join(got_dir, r), shallow=False)]
