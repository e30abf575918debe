"""The port's mesh path (aligngraph2_tpu_torch/parallel/) on the CPU
against the JAX package's (aligngraph2_tpu/parallel/), on the conftest's 8
virtual CPU devices for JAX and lists of CPU devices for the port:

  * ``build_block_index``: every array equal;
  * ``_seed_reads`` (both strands' codes and ``_seed_block_candidates``)
    and ``_select_read_candidates``: equal to
    the JAX functions on seeded inputs with planted count ties (repeats
    at several diagonals, a small k, counts from a small range), with the
    prune off and on;
  * ``LongReadAligner(mesh=...)``: .ref text equal to the JAX mesh path's
    (``make_mesh(8, block_parallel=2)``) for port meshes 1x1, 4x2 and
    2x4, and the quality and reverse-strand cases of
    tests/test_sharded_aligner.py;
  * the mesh's shape rules, and a failure in the mesh path raises (no
    fallback to the single-device path)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aligngraph2_tpu.parallel import sharded as jsh
from aligngraph2_tpu_torch.align.aligner import LongReadAligner
from aligngraph2_tpu_torch.config import AlignerConfig
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
from aligngraph2_tpu_torch.parallel import sharded as tsh
from aligngraph2_tpu_torch.parallel.mesh import make_mesh
from tests.synth import make_dataset, random_genome, revcomp

torch.set_num_threads(1)

CPU = torch.device("cpu")

# tests/test_sharded_aligner.py's small_cfg
SMALL = dict(band_width=128, min_aln_len=100, min_block_hits=3,
             max_candidates=4, seed_k=11, delta=0.5, block_size=2048)


@pytest.fixture(scope="module")
def dataset():
    return make_dataset(seed=5, genome_len=6000, coverage=8,
                        mean_read=900, read_err=0.03)


def _repeat_genome(seed, n=3000, unit=200, copies=(300, 1100, 2200)):
    """Random genome with one ``unit``-bp segment at several offsets: a
    query from it hits each copy's diagonal equally often."""
    rng = np.random.default_rng(seed)
    g = random_genome(rng, n)
    seg = g[100:100 + unit]
    for at in copies:
        g = g[:at] + seg + g[at + unit:]
    return g, seg


def _block_index(pkg, seqs, k, BL, pad):
    if pkg == "jax":
        from aligngraph2_tpu.io.seqdb import SeqDatabase as JDB
        return jsh.build_block_index(JDB(seqs), k, BL, pad_blocks_to=pad)
    return tsh.build_block_index(SeqDatabase(seqs), k, BL, pad_blocks_to=pad)


@pytest.mark.parametrize("k, BL, pad", [(11, 1024, 1), (5, 512, 4)])
def test_build_block_index_equals_jax(k, BL, pad):
    g, _ = _repeat_genome(1)
    seqs = [("a", g), ("b", g[500:1700]), ("c", "ACGT")]
    want = _block_index("jax", seqs, k, BL, pad)
    got = _block_index("torch", seqs, k, BL, pad)
    assert got._fields == want._fields
    for name in want._fields:
        w, t = getattr(want, name), getattr(got, name)
        if isinstance(w, np.ndarray):
            assert t.dtype == w.dtype, name
            np.testing.assert_array_equal(t, w, err_msg=name)
        else:
            assert t == w, name


def _queries(seed, seg, NQ):
    """(B, NQ) uint8 codes and lengths: the repeated segment and pieces of
    it (planted ties), random reads, a read shorter than k, an empty row."""
    from aligngraph2_tpu_torch.io.seqdb import encode_seq
    rng = np.random.default_rng(seed)
    reads = [seg, seg[20:180], revcomp(seg), random_genome(rng, NQ),
             random_genome(rng, 300), "ACG", ""]
    q = np.zeros((len(reads), NQ), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, r in enumerate(reads):
        c = encode_seq(r) if r else np.zeros(0, np.uint8)
        q[i, :len(c)] = c
        lens[i] = len(c)
    return q, lens


@pytest.mark.parametrize("k, BL, occ", [(11, 1024, 4), (5, 512, 2)])
def test_seed_block_candidates_equals_jax(k, BL, occ):
    """Per (read, strand, block) top-T bins and their mean diagonals,
    exactly: the port's fused entry (``_seed_reads``: both strands' k-mer
    codes and the histogram) against the JAX package's k-mer codes and
    ``_seed_block_candidates`` a strand.  The repeats give equal counts
    at several bins, which must come out in lax.top_k's order (the lower
    bin first)."""
    from aligngraph2_tpu.ops.kmer import kmer_codes_batch as jcodes
    g, seg = _repeat_genome(2)
    idx = _block_index("jax", [("g", g)], k, BL, 1)
    NQ, bin_w, T = 512, 64, 4
    q, lens = _queries(3, seg, NQ)
    q_rev = q[::-1].copy()   # any second strand: the rows reversed
    nbins = int(np.ceil((BL + NQ) / bin_w)) + 2
    kw = dict(NQ=NQ, nbins=nbins, bin_w=bin_w, occ=occ, max_occ=64,
              top_t=T)
    want = []
    for qs in (q, q_rev):
        qc, qv = jcodes(jnp.asarray(qs), jnp.asarray(lens), k)
        want.append(jsh._seed_block_candidates(
            qc, qv, jnp.asarray(idx.sorted_codes),
            jnp.asarray(idx.sorted_pos), **kw))
    want = [np.stack([np.asarray(w[j]) for w in want], 1) for j in (0, 1)]
    sc = torch.from_numpy(idx.sorted_codes)
    got = tsh._seed_reads(torch.from_numpy(q), torch.from_numpy(q_rev),
                          torch.from_numpy(lens), sc,
                          torch.from_numpy(idx.sorted_pos),
                          tsh.seed_directory(sc, k), k=k, **kw)
    cnt_w = want[0]
    # the planted ties are there: equal non-zero counts in one (read, block)
    assert any(len(set(row[row > 0])) < (row > 0).sum()
               for row in cnt_w.reshape(-1, T))
    for w, t, name in zip(want, got, ("cnt", "diag")):
        assert t.dtype == torch.int32 and t.shape == w.shape
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


@pytest.mark.parametrize("prune", [0.0, 0.3, 0.81])
def test_select_read_candidates_equals_jax(prune):
    """Dedup, clamp, prune and first-K pick, exactly, on counts drawn from
    a small range (many ties) with nearby diagonals on few targets."""
    rng = np.random.default_rng(int(prune * 100))
    B, N = 24, 48
    cnt = rng.integers(0, 7, (B, N)).astype(np.int32)
    cnt[:, 5] = cnt[:, 9] = 6              # planted tie at the top
    tid = rng.choice(np.array([-2, -1, 1, 2], np.int32), N)
    gdiag = rng.integers(0, 130, (B, N)).astype(np.int32)
    kw = dict(K=8, min_hits=2, alpha=0.5, beta=2.0, bin_w=64, prune=prune)
    want = jax.vmap(functools.partial(jsh._select_read_candidates, **kw))(
        jnp.asarray(cnt), jnp.broadcast_to(jnp.asarray(tid), (B, N)),
        jnp.asarray(gdiag))
    got = tsh._select_read_candidates(torch.from_numpy(cnt),
                                      torch.from_numpy(tid),
                                      torch.from_numpy(gdiag), **kw)
    sel = np.asarray(want[0])
    assert sel.any() and not sel.all()
    for w, t, name in zip(want, got, ("sel", "idx", "score")):
        w = np.asarray(w)
        assert t.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


@pytest.fixture(scope="module")
def jax_mesh_text(dataset):
    from aligngraph2_tpu.align.aligner import LongReadAligner as JA
    from aligngraph2_tpu.config import AlignerConfig as JC
    from aligngraph2_tpu.io.seqdb import SeqDatabase as JDB
    from aligngraph2_tpu.parallel.mesh import make_mesh as jmesh
    alns = JA(JDB([("g", dataset["genome"])]), JC(**SMALL),
              mesh=jmesh(8, block_parallel=2)).align_reads(
                  JDB(dataset["reads"]))
    assert len(alns) > 0
    return alns.to_ref_text()


def _mesh_align(dataset, data, block, db=None, reads=None):
    mesh = make_mesh(devices=[CPU] * (data * block), block_parallel=block)
    db = db or SeqDatabase([("g", dataset["genome"])])
    return LongReadAligner(db, AlignerConfig(**SMALL), mesh=mesh
                           ).align_reads(reads or SeqDatabase(dataset["reads"]))


@pytest.mark.parametrize("data, block", [(1, 1), (4, 2), (2, 4)])
def test_mesh_path_equals_jax(dataset, jax_mesh_text, data, block):
    assert _mesh_align(dataset, data, block).to_ref_text() == jax_mesh_text


def test_sharded_alignment_quality(dataset):
    """tests/test_sharded_aligner.py's bar: nearly every read aligns, and
    the records spell their claimed intervals."""
    reads = SeqDatabase(dataset["reads"])
    genome = SeqDatabase([("g", dataset["genome"])])
    alns = _mesh_align(dataset, 4, 2, genome, reads)
    assert len({a.query_name for a in alns}) >= 0.9 * len(reads)
    rseq = genome.get_str(0)
    for a in alns:
        assert a.qsize == reads.size(reads.seq_id(a.query_name))
        assert 0 <= a.rb < a.re <= genome.size(0)
        assert 0 <= a.qb < a.qe <= a.qsize
        assert a.tstr.replace("-", "") == rseq[a.rb:a.re]
        qseq = reads.get_str(reads.seq_id(a.query_name), a.forward)
        assert a.qstr.replace("-", "") == qseq[
            a.qb if a.forward else a.qsize - a.qe:
            a.qe if a.forward else a.qsize - a.qb]


def test_sharded_multi_target_and_revcomp(dataset):
    """A reverse-strand read and a multi-sequence target land on the right
    target with the right orientation."""
    genome = dataset["genome"]
    reads = SeqDatabase([("fwd", genome[1000:1900]),
                         ("rev", revcomp(genome[3000:3900]))])
    db = SeqDatabase([("decoy", dataset["similar"][0][1][:2000]),
                      ("g", genome)])
    by_read = {}
    for a in _mesh_align(dataset, 4, 2, db, reads):
        by_read.setdefault(a.query_name, []).append(a)
    best_f = max(by_read["fwd"], key=lambda a: a.score)
    assert best_f.ref_name == "g" and best_f.forward
    assert abs(best_f.rb - 1000) < 100
    best_r = max(by_read["rev"], key=lambda a: a.score)
    assert best_r.ref_name == "g" and not best_r.forward
    assert abs(best_r.rb - 3000) < 100


def test_make_mesh_shapes():
    assert make_mesh(devices=[CPU] * 8).shape == {"data": 4, "block": 2}
    assert make_mesh(devices=[CPU] * 2).shape == {"data": 2, "block": 1}
    m = make_mesh(6, block_parallel=3, devices=[CPU] * 8,
                  data_axis="d", block_axis="b")
    assert m.shape == {"d": 2, "b": 3} and m.size == 6
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(devices=[CPU] * 6, block_parallel=4)


def test_mesh_failure_raises(dataset, monkeypatch):
    """A failing extension raises out of align_reads: there is no fallback
    to the single-device path."""
    def broken(*a, **kw):
        raise RuntimeError("extension failed")
    monkeypatch.setattr(tsh, "_extend_body", broken)
    reads = SeqDatabase(dataset["reads"][:4])
    with pytest.raises(RuntimeError, match="extension failed"):
        _mesh_align(dataset, 1, 1, reads=reads)
