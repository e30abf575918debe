"""The port's tracing (``aligngraph2_tpu_torch/utils/timing.py``): the
aligner's spans and counters while a profiler records, and nothing while
none does.

  * the mesh path on 1x1 and 2x1 meshes of the CPU device, traced: every
    span, each part inside an instance of the span it belongs to, and
    the counters' relations;
  * the same run untraced: no counter, no ``record_function`` entered,
    the same records;
  * the counters of two traced stretches apart;
  * the single-device path's finish split (``band="static"``);
  * on a card (skips without one): ``adaptive.rows`` against the rows
    ``dp_adaptive`` returned.  Run there with
    ``python -m pytest --noconftest tests/test_torch_trace.py -q``
    (``tests/conftest.py`` imports JAX, which a card's environment need
    not have).

The inputs are tiny: a traced run records every torch op of the CPU's
plain band."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aligngraph2_tpu_torch.align.aligner import LongReadAligner
from aligngraph2_tpu_torch.config import AlignerConfig
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase, revcomp_codes
from aligngraph2_tpu_torch.parallel import sharded
from aligngraph2_tpu_torch.parallel.mesh import make_mesh
from aligngraph2_tpu_torch.utils import timing
from tests.synth import make_dataset

CFG = dict(band_width=32, min_aln_len=100, min_block_hits=3,
           max_candidates=4, seed_k=11, delta=0.5, block_size=1024)
# every span of each path, and the span each part lies inside
MESH_SPANS = {"align.index": None, "align.pack": None, "align.seed": None,
              "align.seed.wait": "align.seed", "align.compact": None,
              "align.prep": None, "align.dispatch": None,
              "align.dispatch.wait": "align.dispatch",
              "align.finish": None, "align.finish.strings": "align.finish",
              "align.finish.emit": "align.finish"}
SINGLE_SPANS = {"align.index": None, "align.seed": None,
                "align.prep": None, "align.dispatch": None,
                "align.finish": None, "align.finish.strings": "align.finish",
                "align.finish.emit": "align.finish"}


@pytest.fixture(scope="module")
def data():
    ds = make_dataset(seed=15, genome_len=3000, coverage=3, mean_read=420,
                      read_err=0.03)
    # reads of one 512 bucket, so the plain band runs few rows
    reads = [r for r in ds["reads"] if 250 <= len(r[1]) <= 512][:4]
    assert len(reads) >= 3
    return SeqDatabase([("g", ds["genome"])]), SeqDatabase(reads)


@pytest.fixture(autouse=True)
def fresh_registry(monkeypatch):
    """Each test starts with no counters."""
    monkeypatch.setattr(timing, "_counts", {})


def _aligner(db, shape=None, device="cpu"):
    if shape is None:
        return LongReadAligner(db, AlignerConfig(**CFG), device="cpu",
                               band="static")
    data_par, block = shape
    mesh = make_mesh(devices=[torch.device(device)] * (data_par * block),
                     block_parallel=block)
    return LongReadAligner(db, AlignerConfig(**CFG), mesh=mesh)


def _traced(make, reads, activities=(ProfilerActivity.CPU,)):
    """Build the aligner and align ``reads`` under the profiler: (records,
    spans as (name, start ns, end ns), the counters)."""
    timing.tracing()   # an untraced call: the traced stretch starts anew
    with profile(activities=list(activities)) as prof:
        out = make().align_reads(reads)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and str(e.device_type()).endswith(
                 "CPU")]
    return out, spans, timing.counts()


def _check_spans(spans, want):
    names = {n for n, _, _ in spans}
    assert set(want) <= names, set(want) - names
    assert {n for n in names if n.startswith("align.")} <= set(want)
    for name, s, e in spans:
        parent = want.get(name)
        if parent is not None:
            assert any(p == parent and ps <= s and e <= pe
                       for p, ps, pe in spans), (name, s, e)


@pytest.fixture(scope="module", params=[(1, 1), (2, 1)],
                ids=["mesh1x1", "mesh2x1"])
def mesh_run(request, data):
    """(mesh shape, the traced run of the mesh path)."""
    db, reads = data
    return request.param, _traced(lambda: _aligner(db, request.param),
                                  reads)


def test_mesh_spans_and_counters(mesh_run):
    _, (out, spans, c) = mesh_run
    _check_spans(spans, MESH_SPANS)
    assert 0 < c["extend.lanes"] <= c["extend.lane_slots"]
    assert c["align.records"] == len(out) <= c["extend.lanes"]
    # the CPU's plain band counts no rows
    assert "adaptive.rows" not in c and "adaptive.row_slots" not in c


def test_mesh_untraced_is_silent(data, mesh_run, monkeypatch):
    db, reads = data
    shape, (traced, _, _) = mesh_run
    entered = []
    monkeypatch.setattr(timing, "record_function", entered.append)
    out = _aligner(db, shape).align_reads(reads)
    assert timing.counts() == {} and entered == []
    assert out.to_ref_text() == traced.to_ref_text()


def test_counts_hold_the_latest_traced_stretch():
    with profile(activities=[ProfilerActivity.CPU]):
        timing.count("a", 2)
        timing.count("a")
    assert timing.counts() == {"a": 3}
    timing.count("a", 5)   # untraced: not counted, and ends the stretch
    assert timing.counts() == {"a": 3}
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("x"):
            timing.count("b")
    assert timing.counts() == {"b": 1}


def test_single_path_finish_split(data):
    db, reads = data
    out, spans, c = _traced(lambda: _aligner(db), reads)
    _check_spans(spans, SINGLE_SPANS)
    assert c == {"align.records": len(out)}
    assert _aligner(db).align_reads(reads).to_ref_text() == \
        out.to_ref_text()


@pytest.mark.card
def test_card_rows_count_dp_adaptive(data, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    db, reads = data
    launched = []
    real = sharded.dp_adaptive

    def keep(*a, **kw):
        res, rows = real(*a, **kw)
        launched.append(rows)
        return res, rows

    monkeypatch.setattr(sharded, "dp_adaptive", keep)
    out, spans, c = _traced(lambda: _aligner(db, (1, 1), "cuda:0"), reads,
                            (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    _check_spans(spans, MESH_SPANS)
    rows = [r.cpu() for r in launched]
    assert rows and c["adaptive.rows"] == sum(int(r.sum()) for r in rows)
    assert c["adaptive.row_slots"] == sum(len(r) * int(r.max())
                                          for r in rows)
    assert 0 < c["adaptive.rows"] <= c["adaptive.row_slots"]
    assert 0 < c["extend.lanes"] <= c["extend.lane_slots"]
    assert c["align.records"] == len(out) <= c["extend.lanes"]


# ---------------------------------------------------------------------------
# the mesh seeder's counters


def _seeder_call(db, reads, shape, live_rows):
    """One call of the mesh seeder over a (data x block) mesh of the CPU
    device on the first ``live_rows`` of 4 rows of reads (the rest
    padding): (its outputs, rows a data row, NB padded, N)."""
    data_par, block_par = shape
    k, K = CFG["seed_k"], CFG["max_candidates"]
    BL = sharded.mesh_block_len(int(db.lengths.max()), CFG["block_size"],
                                CFG["band_width"])
    index = sharded.build_block_index(db, k, BL, pad_blocks_to=block_par)
    mesh = make_mesh(devices=[torch.device("cpu")] * (data_par * block_par),
                     block_parallel=block_par)
    seeder = sharded.make_sharded_seeder(
        mesh, k=k, BL=BL, bin_w=32, min_hits=CFG["min_block_hits"], K=K,
        prune=0.25)
    q_fwd, q_rev = (np.zeros((4, 512), np.uint8) for _ in range(2))
    lens = np.zeros(4, np.int32)
    for r in range(live_rows):
        codes = reads.get_codes(r)
        q_fwd[r, :len(codes)] = codes
        q_rev[r, :len(codes)] = revcomp_codes(codes)
        lens[r] = len(codes)
    NB = len(index.block_lens)
    out = seeder(q_fwd, q_rev, lens, *sharded.put_sharded_index(index, mesh))
    return out, 4 // data_par, NB, 2 * NB * K


@pytest.mark.parametrize("shape, live_rows, live_data_rows", [
    ((1, 1), 3, 1), ((2, 2), 4, 2), ((2, 2), 2, 1)],
    ids=["mesh1x1", "mesh2x2", "mesh2x2-padding-row"])
def test_seeder_counters(data, shape, live_rows, live_data_rows):
    """Traced: 2 B NB read-block pairs and B N candidates over the data
    rows that hold a read (a row of padding only is not run), the kept
    candidates as sel's sum, and no scratch row on the CPU."""
    db, reads = data
    with profile(activities=[ProfilerActivity.CPU]):
        out, per, NB, N = _seeder_call(db, reads, shape, live_rows)
    c = timing.counts()
    assert NB % shape[1] == 0
    assert c == {"seed.read_blocks": live_data_rows * 2 * per * NB,
                 "select.candidates": live_data_rows * per * N,
                 "seed.selected": int(out[0].sum())}
    assert c["seed.selected"] > 0


def test_seeder_untraced_counts_nothing(data):
    db, reads = data
    timing.tracing()
    _seeder_call(db, reads, (2, 2), 4)
    assert timing.counts() == {}


@pytest.mark.parametrize("N, scratch", [(96, False), (8192, False),
                                        (8193, True), (12720, True)])
def test_select_scratch_rows(monkeypatch, N, scratch):
    """The card wrapper counts a call's rows as ``select.scratch_rows``
    when their table is past the shared slots (N > 8,192), else 0; the
    launch is stubbed, so only the wrapper's own arithmetic runs."""
    from aligngraph2_tpu_torch.ops import _cuda

    class Lib:
        @staticmethod
        def agc_select_candidates(*args):
            return 0

    monkeypatch.setattr(_cuda, "need", lambda *a, **kw: None)
    monkeypatch.setattr(_cuda, "get_seed_lib", Lib)
    monkeypatch.setattr(_cuda, "launch_target", lambda dev: (0, 0))
    B = 3
    cnt, gdiag = (torch.zeros((B, N), dtype=torch.int32) for _ in range(2))
    tid = torch.ones(N, dtype=torch.int32)
    kw = dict(K=8, min_hits=4, alpha=0.5, beta=2.0, bin_w=128)
    sharded.select_candidates(cnt, tid, gdiag, **kw)
    assert timing.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        sharded.select_candidates(cnt, tid, gdiag, **kw)
    assert timing.counts() == {"select.scratch_rows": B if scratch else 0}
