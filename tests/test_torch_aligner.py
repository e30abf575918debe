"""The port's aligner (aligngraph2_tpu_torch/align/aligner.py) on the CPU
against the JAX package's single-device aligner on the CPU
(use_pallas=False), on the dataset and config of tests/test_aligner.py:
the .ref text must be byte-identical.  Configs cross over with
dataclasses.asdict; records cross over as .ref text."""

import dataclasses

import numpy as np
import pytest
import torch

from aligngraph2_tpu.align import aligner as jal
from aligngraph2_tpu.align.records import AlignmentSet as JSet
from aligngraph2_tpu.config import AlignerConfig as JConfig
from aligngraph2_tpu.io.seqdb import SeqDatabase as JDB
from aligngraph2_tpu_torch.align import aligner as tal
from aligngraph2_tpu_torch.align.records import AlignmentSet as TSet
from aligngraph2_tpu_torch.config import AlignerConfig as TConfig
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase as TDB
from tests.synth import make_dataset, mutate, random_genome, sample_reads

torch.set_num_threads(1)


def small_cfg(**kw):
    """tests/test_aligner.py's config, as the JAX package's dataclass."""
    d = dict(band_width=128, min_aln_len=100, min_block_hits=3,
             max_candidates=4, seed_k=11, delta=0.5)
    d.update(kw)
    return JConfig(**d)


def to_port(cfg: JConfig) -> TConfig:
    return TConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def dataset():
    return make_dataset(seed=3, genome_len=6000, coverage=8,
                        mean_read=900, read_err=0.03)


def _both(recs_t, recs_q, cfg, ids=None):
    """(JAX .ref text, port .ref text) of one align_reads call."""
    want = jal.LongReadAligner(JDB(recs_t), cfg, use_pallas=False) \
        .align_reads(JDB(recs_q), ids=ids)
    got = tal.LongReadAligner(TDB(recs_t), to_port(cfg), device="cpu") \
        .align_reads(TDB(recs_q), ids=ids)
    return want.to_ref_text(), got.to_ref_text()


@pytest.mark.parametrize("target", ["genome", "similar"])
def test_align_reads_ref_text_identical(dataset, target):
    recs = ([("g", dataset["genome"])] if target == "genome"
            else dataset["similar"])
    want, got = _both(recs, dataset["reads"], small_cfg())
    assert want.count("\n") > 100
    assert got == want


def test_align_chunked_ref_text_identical(dataset):
    cfg = small_cfg(chunk_len=1000)
    want = jal.align_chunked(JDB(dataset["similar"]),
                             JDB(dataset["contigs"]), cfg)
    got = tal.align_chunked(TDB(dataset["similar"]),
                            TDB(dataset["contigs"]), to_port(cfg),
                            device="cpu")
    assert len(got) >= 2
    assert got.to_ref_text() == want.to_ref_text()


def test_ref_records_cross_read(tmp_path, dataset):
    """Each package reads the other's .ref file back to the same text."""
    recs = dataset["reads"][:10]
    want, got = _both([("g", dataset["genome"])], recs, small_cfg())
    pj, pt = tmp_path / "jax.ref", tmp_path / "port.ref"
    pj.write_text(want)
    pt.write_text(got)
    assert TSet.read_ref(str(pj)).to_ref_text() == want
    assert JSet.read_ref(str(pt)).to_ref_text() == got


def test_checkpoint_resume_identical(tmp_path, dataset):
    """A run cut after its first flushed chunk resumes to the output of an
    uninterrupted run (tests/test_align_checkpoint.py, on the port)."""
    reads = TDB(dataset["reads"])
    refs = TDB(dataset["similar"])
    cfg = to_port(small_cfg())
    fresh = tal.LongReadAligner(refs, cfg, device="cpu") \
        .align_reads(reads).to_ref_text()
    part = str(tmp_path / "stage.part")
    first = tal.LongReadAligner(refs, cfg, device="cpu",
                                checkpoint_path=part,
                                checkpoint_flush_s=0.0).align_reads(reads)
    assert first.to_ref_text() == fresh
    with open(part) as f:
        lines = f.readlines()
    n, cursor = map(int, lines[1].split()[1:])
    assert lines[0].startswith("#TOKEN") and 0 < cursor
    with open(part, "w") as f:
        f.writelines(lines[:2 + 3 * n])
    resumed = tal.LongReadAligner(refs, cfg, device="cpu",
                                  checkpoint_path=part,
                                  checkpoint_flush_s=0.0).align_reads(reads)
    assert resumed.to_ref_text() == fresh


def test_static_band_records_spell_their_intervals(dataset):
    """band="static" on the CPU (the plain versions of the CUDA kernels):
    the records are well formed (tests/test_aligner.py:25-47)."""
    reads = TDB(dataset["reads"])
    genome = TDB([("g", dataset["genome"])])
    alns = tal.LongReadAligner(genome, to_port(small_cfg()), device="cpu",
                               band="static").align_reads(reads)
    aligned = {a.query_name for a in alns}
    assert len(aligned) >= 0.9 * len(reads)
    rseq = genome.get_str(0)
    for a in alns:
        assert a.qsize == reads.size(reads.seq_id(a.query_name))
        assert 0 <= a.rb < a.re <= genome.size(0)
        assert 0 <= a.qb < a.qe <= a.qsize
        assert a.tstr.replace("-", "") == rseq[a.rb:a.re]
        qseq = reads.get_str(reads.seq_id(a.query_name), a.forward)
        lo, hi = ((a.qb, a.qe) if a.forward
                  else (a.qsize - a.qe, a.qsize - a.qb))
        assert a.qstr.replace("-", "") == qseq[lo:hi]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    """Without a CUDA device the default raises instead of quietly
    running on the CPU; plain=True is refused outside the static band."""
    db = TDB([("g", "ACGT" * 50)])
    cfg = to_port(small_cfg())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tal.LongReadAligner(db, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tal.align_chunked(db, db, cfg)
    with pytest.raises(ValueError):
        tal.LongReadAligner(db, cfg, device="cpu", band="adaptive",
                            plain=True)
    assert tal.LongReadAligner(db, cfg, device="cpu").band == "adaptive"


def test_ref_seed_rescue_identical():
    """The driver's two-level similar-genome seeding
    (tests/test_aligner.py:253) gives the same records on both sides."""
    rng = np.random.default_rng(17)
    genome = random_genome(rng, 60_000)
    similar = (mutate(rng, genome[:30_000], 0.01, 0.0025, 0.0025)
               + mutate(rng, genome[30_000:], 0.12, 0.03, 0.03))
    reads = sample_reads(rng, genome, coverage=3, mean_len=2000, err=0.05)
    small = JConfig(seed_k=9, band_width=128, min_block_hits=3,
                    min_aln_len=150)
    big = dataclasses.replace(small, seed_k=16)   # leaves a few unaligned
    refs = [("ref", similar)]
    p1_j, p1_t = _both(refs, reads, big)
    assert p1_t == p1_j
    got = {ln.split("\t")[0] for ln in p1_t.splitlines()[::3]}
    miss = [i for i, (nm, _) in enumerate(reads) if nm not in got]
    assert miss, "every read aligned in the first pass (setup broken)"
    p2_j, p2_t = _both(refs, reads, small, ids=miss)
    assert p2_t == p2_j


@pytest.mark.slow
def test_static_band_equals_jax_pallas_path(dataset, monkeypatch):
    """band="static" on the CPU (the plain versions of the CUDA kernels)
    against the JAX aligner's Pallas path, its kernel in interpret mode
    (small tiles: interpret mode at the production tile takes tens of
    minutes).  About a minute for three reads, hence slow."""
    import functools
    from aligngraph2_tpu.ops import banded_pallas as bp
    monkeypatch.setattr(bp, "banded_align_pallas", functools.partial(
        bp.banded_align_pallas, interpret=True, K=16, TB=8))
    recs = [("g", dataset["genome"])]
    reads = dataset["reads"][:3]
    want = jal.LongReadAligner(JDB(recs), small_cfg(), use_pallas=True) \
        .align_reads(JDB(reads))
    got = tal.LongReadAligner(TDB(recs), to_port(small_cfg()),
                              device="cpu", band="static") \
        .align_reads(TDB(reads))
    assert len(got) == 3
    assert got.to_ref_text() == want.to_ref_text()


def _fake_jobs(lengths):
    """Aligner jobs (rid, cand, codes) sorted by length, as align_reads
    forms them; only the length of the codes matters to the batch plan."""
    return [(r, None, np.zeros(n, np.uint8))
            for r, n in enumerate(sorted(lengths))]


@pytest.mark.parametrize("n, static", [(9000, True), (32768, True),
                                       (65536, True), (65537, False),
                                       (131072, False)])
def test_batch_plan_sends_long_buckets_to_adaptive_band(n, static):
    """Under band="static" a bucket takes the static band up to NQ = 65536
    and the adaptive band past it, sized as an adaptive batch, as the JAX
    package decides (pallas_ok, aligngraph2_tpu/align/aligner.py:205)."""
    db = TDB([("g", "ACGT" * 50)])
    cfg = small_cfg()
    al = tal.LongReadAligner(db, to_port(cfg), device="cpu", band="static")
    jal_al = jal.LongReadAligner(JDB([("g", "ACGT" * 50)]), cfg,
                                 use_pallas=True)
    jobs = _fake_jobs([n] * 300)
    plan = al._plan(jobs)
    NQ = tal._bucket(n)
    assert NQ == jal._bucket(n)
    assert all(p[0] == NQ and p[1] == static for p in plan)
    assert [len(p[2]) for p in plan][0] == min(
        300, jal_al._batch_size(NQ, static))
    assert plan[-1][3] == len(jobs)
    assert sum(len(p[2]) for p in plan) == len(jobs)
    # the adaptive band never plans a static batch
    al.band = "adaptive"
    assert not any(p[1] for p in al._plan(jobs))


@pytest.mark.slow
def test_read_past_65536_takes_adaptive_band_under_static():
    """A read just past the 65536 bucket gives the same records under
    band="static" (plain versions, on the CPU) as under band="adaptive",
    whose records equal the JAX package's on the CPU: the static aligner
    routes it to the adaptive band as the JAX package does."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 86_000)
    read = mutate(rng, genome[10_000:76_000], 0.02, 0.01, 0.01)
    assert len(read) > 65536
    target = TDB([("genome", genome)])
    reads = TDB([("long_read", read)])
    cfg = to_port(JConfig())
    got = tal.LongReadAligner(target, cfg, device="cpu", band="static") \
        .align_reads(reads)
    want = tal.LongReadAligner(target, cfg, device="cpu",
                               band="adaptive").align_reads(reads)
    assert len(got) >= 1 and got[0].qe - got[0].qb > 60_000
    assert got.to_ref_text() == want.to_ref_text()
