"""One reference group of the legacy 6 kb pipeline dataset
(tests/test_pipeline.py), built the same way in both packages, for the
port's graph, traversal and consensus parity tests.

The alignments come from the JAX package's single-device aligner on the
CPU and cross over to the port as .ref text, so both packages start from
the same records; each package then groups the contigs and subsets the
alignments with its own code, as its driver does."""

from __future__ import annotations

import functools
import importlib

import numpy as np

from tests.synth import make_dataset

GRAPH_K = 12
THRESHOLD = 0.05


def jax_aligner_cfg():
    """tests/test_pipeline.py small_cfg's aligner values."""
    from aligngraph2_tpu.config import AlignerConfig
    return AlignerConfig(band_width=128, min_aln_len=150, min_block_hits=3,
                         seed_k=11, delta=0.5, chunk_len=1500)


def module(pkg: str, name: str):
    """Module ``name`` of package ``pkg``: "jax" (the JAX package) or
    "torch" (the port)."""
    root = "aligngraph2_tpu" if pkg == "jax" else "aligngraph2_tpu_torch"
    return importlib.import_module(f"{root}.{name}")


@functools.lru_cache(maxsize=1)
def dataset():
    return make_dataset(seed=21, genome_len=6000, coverage=14,
                        mean_read=1000, read_err=0.02, n_contigs=2,
                        contig_gap=350)


@functools.lru_cache(maxsize=1)
def ref_texts():
    """(read->contig, read->similar, contig->similar) .ref text."""
    from aligngraph2_tpu.align.aligner import LongReadAligner, align_chunked
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    ds = dataset()
    reads = SeqDatabase(ds["reads"])
    ctgs = SeqDatabase(ds["contigs"])
    refs = SeqDatabase(ds["similar"])
    cfg = jax_aligner_cfg()
    r2c = LongReadAligner(ctgs, cfg, use_pallas=False).align_reads(reads)
    r2r = LongReadAligner(refs, cfg, use_pallas=False).align_reads(reads)
    c2r = align_chunked(refs, ctgs, cfg)
    return r2c.to_ref_text(), r2r.to_ref_text(), c2r.to_ref_text()


def group_inputs(pkg: str) -> dict:
    """The first group's inputs in package ``pkg`` ("jax" or "torch"),
    subset as the pipeline driver subsets them."""
    SeqDatabase = module(pkg, "io.seqdb").SeqDatabase
    AlignmentSet = module(pkg, "align.records").AlignmentSet
    pre = module(pkg, "pipeline.preprocess")
    kmer = module(pkg, "ops.kmer")
    ds = dataset()
    reads = SeqDatabase(ds["reads"])
    ctgs = SeqDatabase(ds["contigs"])
    refs = SeqDatabase(ds["similar"])
    r2c, r2r, c2r = (AlignmentSet.from_ref_text(t, keep_strings=False)
                     for t in ref_texts())
    groups = pre.group_contigs(ctgs, c2r, 1, 0.15)
    assert groups, "no reference group formed"
    group = groups[0]
    members = {n for n, _ in group.contigs}
    read_names = pre.group_read_names(
        group, pre.subset_alignments(r2c, None, members),
        pre.subset_alignments(r2r, None, {group.ref_name}))
    return dict(
        group=group, solid=kmer.solid_set(reads, GRAPH_K, THRESHOLD),
        reads=reads.subset_by_names(read_names),
        ctgs=ctgs.subset_by_names(members),
        refs=refs.subset_by_names({group.ref_name}),
        r2c=pre.subset_alignments(r2c, read_names, members),
        r2r=pre.subset_alignments(r2r, read_names, {group.ref_name}),
        c2r=pre.subset_alignments(c2r, members, {group.ref_name}))


def build_graph(pkg: str, use_native: bool = True):
    """(PAGraph, PositionProcessor, inputs) of the first group after
    pre_process and process, in package ``pkg``."""
    PAGraph = module(pkg, "graph.pagraph").PAGraph
    proc = module(pkg, "graph.processor")
    gcfg = module(pkg, "config").GraphConfig(k=GRAPH_K,
                                             solid_threshold=THRESHOLD)
    inp = group_inputs(pkg)
    graph = PAGraph(inp["solid"], GRAPH_K)
    pp = proc.PositionProcessor(graph, inp["reads"], inp["ctgs"],
                                inp["refs"], inp["r2c"], inp["r2r"],
                                inp["c2r"], inp["group"], gcfg)
    pp.pre_process()
    pp.process(log=lambda *a: None, threads=2, use_native=use_native)
    return graph, pp, inp


GRAPH_ARRAYS = ("node_codes", "pos_node", "pos_ctg", "pos_ref",
                "pos_count", "pos_start", "edge_from", "edge_to",
                "edge_step", "edge_start")


def graph_arrays(graph) -> dict:
    return {name: np.asarray(getattr(graph, name)) for name in GRAPH_ARRAYS}
