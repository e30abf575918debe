"""The deployment generator: one seed, one deployment; the sizes the
configuration states."""

import numpy as np
import pytest

from portbench import deployment, synth

from .conftest import tiny_spec

BIG_SEED = 2 ** 31 + 2 ** 33 + 17


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_same_seed_same_data(path):
    cfg = tiny_spec(path)["config"]
    parts = {"genome", "similar", "reads"} | (
        {"contigs"} if path == "single" else set())
    a = deployment.build(cfg, BIG_SEED, 2.0, parts)
    b = deployment.build(cfg, BIG_SEED, 2.0, parts)
    c = deployment.build(cfg, BIG_SEED + 1, 2.0, parts)
    for k in parts:
        assert np.array_equal(a[k].codes, b[k].codes)
        assert np.array_equal(a[k].offsets, b[k].offsets)
        assert a[k].names == b[k].names
    assert not np.array_equal(a["reads"].codes[:1000],
                              c["reads"].codes[:1000])


def test_parts_drawn_apart():
    """A part is the same whether or not the others are made."""
    cfg = tiny_spec("single")["config"]
    a = deployment.build(cfg, 5, 1.0, {"reads"})
    b = deployment.build(cfg, 5, 1.0, {"reads", "contigs", "similar"})
    assert np.array_equal(a["reads"].codes, b["reads"].codes)


def test_chromosome_lengths_and_coverage():
    cfg = tiny_spec("mesh")["config"]
    d = deployment.build(cfg, 3, 4.0, {"genome", "similar", "reads"})
    assert d["genome"].names == ["c1", "c2"]
    assert list(d["genome"].lengths) == [30000, 20000]
    assert d["similar"].names == ["c1", "c2"]
    assert all(abs(int(n) - m) < 0.02 * m for n, m in
               zip(d["similar"].lengths, (30000, 20000)))
    reads = d["reads"]
    assert reads.names[0] == "1" and reads.names[-1] == str(len(reads))
    # reads cover the genome 4 times, less the deletions' net share
    assert 3.7 * 50000 < reads.lengths.sum() < 4.4 * 50000
    assert reads.codes.max() <= 3
    assert reads.lengths.min() >= 400


def test_scer_genome_lengths():
    cfg = tiny_spec("mesh")["config"]
    from portbench import harness
    cfg["genome"] = harness.read_json("configs",
                                      "scer_s288c_pacbio")["genome"]
    g = deployment.build(cfg, 11, 1.0, {"genome"})["genome"]
    assert len(g) == 16 and int(g.lengths.sum()) == 12_071_326


def test_grouped_mutation_keeps_read_bounds():
    """Mutating reads a group at a time keeps each read's own bases: with
    no errors the reads are the raw segments, whole."""
    rng = np.random.default_rng(0)
    g = [synth.random_codes(rng, 5000)]
    codes, offs = synth.pacbio_reads(np.random.default_rng(1), g, 3.0,
                                     mean_len=800, err=0.0, chimera=0.0)
    text = g[0].tobytes()
    rc = synth.revcomp(g[0]).tobytes()
    for i in range(len(offs) - 1):
        r = codes[offs[i]:offs[i + 1]].tobytes()
        assert r in text or r in rc


def test_every_seed_asks_for_the_same_work():
    """The read sizes are the fixed stream's: two seeds give as many reads,
    of lengths that differ only by each read's own indels, reordered within
    blocks of ORDER_BLOCK."""
    cfg = tiny_spec("mesh")["config"]
    a = deployment.build(cfg, 1, 40.0, {"reads"})["reads"].lengths
    b = deployment.build(cfg, BIG_SEED, 40.0, {"reads"})["reads"].lengths
    assert len(a) == len(b) > synth.ORDER_BLOCK
    assert abs(int(a.sum()) - int(b.sum())) < 0.002 * a.sum()
    blk = synth.ORDER_BLOCK
    assert np.abs(np.sort(a[:blk]) - np.sort(b[:blk])).max() < 0.05 * a.max()
    assert not np.array_equal(a[:blk], b[:blk])
