"""The mesh path's gapped strings made on a card (``tb_strings_kernel``,
``ops/banded_dp.py::gapped_strings``) and their host side:

  * a numpy model of the kernel's rows (header, both strings, zero past
    the move count), written from the kernel's description, against
    ``moves_to_strings`` lane by lane, on lanes of the plain adaptive DP
    and traceback at W 16, 256 and 2048 (lanes scoring 0 among them), with
    whole walks and walks cut by ``max_steps``, and on degenerate walks
    that hit both upper clamps, count a negative index from the end, or
    make ``moves_to_strings`` raise;
  * ``_extend_lanes`` fed an extender that returns the model's rows as a
    card's: the records equal the moves route's on CPU meshes, no
    ``moves_to_strings`` call, and ``extend.card_strings`` counts every
    live lane (0 on the CPU's own route);
  * on a card (skips without one): the kernel against the model, every
    byte of every row, and against ``moves_to_strings`` at W 256 and 2048,
    and a traced mesh call's ``extend.card_strings`` against
    ``extend.lanes``, its records equal to the CPU mesh's.  Run there with
    ``python -m pytest --noconftest tests/test_torch_card_strings.py -q``.

Every comparison is exact."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from aligngraph2_tpu_torch.align import aligner as taligner
from aligngraph2_tpu_torch.align.aligner import LongReadAligner
from aligngraph2_tpu_torch.config import AlignerConfig
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
from aligngraph2_tpu_torch.ops import banded_dp as tdp
from aligngraph2_tpu_torch.parallel import sharded as tsh
from aligngraph2_tpu_torch.parallel.mesh import make_mesh
from aligngraph2_tpu_torch.utils import timing
from tests.synth import make_dataset

torch.set_num_threads(1)

NQ = 128
KW = dict(match=2, mismatch=-4, gap=-3)
# tests/test_torch_sharded.py's small configuration
SMALL = dict(band_width=128, min_aln_len=100, min_block_hits=3,
             max_candidates=4, seed_k=11, delta=0.5, block_size=2048)


def _np_index(x, n):
    """numpy's index of a[min(x, n - 1)] in an array of n; below 0 where
    numpy raises."""
    x = np.minimum(x, n - 1)
    return np.where(x < 0, x + n, x)


def model_rows(moves, n, si, tb, score, q, qlen, t, tlen):
    """tb_strings_kernel's rows, one lane at a time: the moves in
    START->END order, the exclusive prefix counts of each side's advances
    from si and tb, each advancing side's code read at numpy's index
    (clamped at its length - 1, a negative index once from the end), '-'
    where a side stays or its index is out of range; header (score, si,
    tb, qe, te, n or -1 where an index or a code is out of numpy's range,
    0, 0)."""
    B, max_steps = moves.shape
    stride = tdp.strings_stride(max_steps)
    head = tdp.STRINGS_HEAD
    out = np.zeros((B, head + 2 * stride), np.uint8)
    ascii_of = np.frombuffer(b"ACGT-", np.uint8)
    for b in range(B):
        m = moves[b, :int(n[b])][::-1].astype(np.int64)
        bad = False
        strs = []
        ends = []
        for start, adv, codes, length in (
                (si[b], m != tdp.LEFT, q[b], qlen[b]),
                (tb[b], m != tdp.UP, t[b], tlen[b])):
            pos = int(start) + np.concatenate(([0], np.cumsum(adv)))
            idx = _np_index(pos[:-1], int(length))
            out_of_range = (idx < 0) | (idx >= len(codes))
            bad |= bool(out_of_range.any())
            code = np.where(adv & ~out_of_range,
                            codes[np.clip(idx, 0, len(codes) - 1)], 4)
            bad |= bool((code > 4).any())
            strs.append(ascii_of[np.minimum(code, 4)])
            ends.append(int(pos[-1]))
        out[b, :head] = np.array(
            [score[b], si[b], tb[b], ends[0], ends[1],
             -1 if bad else len(m), 0, 0], np.int32).view(np.uint8)
        out[b, head:head + len(m)] = strs[0]
        out[b, head + stride:head + stride + len(m)] = strs[1]
    return out


def _host_strings(moves, si, tb, q, qlen, t, tlen, b):
    """moves_to_strings of lane b, or IndexError where it raises."""
    try:
        return tdp.moves_to_strings(moves[b], q[b, :qlen[b]], int(si[b]),
                                    int(tb[b]), t[b, :tlen[b]])
    except IndexError as e:
        return e


def _decoded(row):
    try:
        return tdp.decode_strings(row)
    except IndexError as e:
        return e


def _same(got, want):
    if isinstance(want, IndexError):
        return isinstance(got, IndexError)
    return got == want


def _plain_lanes(W, seed, max_steps=None, x_drop=250):
    """chip_smoke's adaptive lanes (two of them set to score 0) through the
    CPU's extend body: (moves, n, si, tb, score, q, qlen, t, tlen) as
    numpy arrays."""
    q, qlen, t, tlen, c0 = chip_smoke.adaptive_lanes(
        np.random.default_rng(seed), 16, NQ, W)
    qlen[3] = 0                     # no row runs: score 0
    tlen[11] = 0                    # no target: score 0
    NT = t.shape[1]
    ms = max_steps or NQ + NT
    (score, moves, si, tb), _ = tsh._extend_body(
        *(torch.from_numpy(x) for x in (q, qlen, t, tlen, c0)), W=W,
        x_drop=x_drop, max_steps=ms, **KW)
    moves = moves.numpy()
    n = np.count_nonzero(moves, axis=1).astype(np.int32)
    return (moves, n, si.numpy(), tb.numpy(), score.numpy(), q, qlen, t,
            tlen)


@pytest.mark.parametrize("W", [16, 256, 2048])
@pytest.mark.parametrize("walk", ["whole", "cut"])
def test_model_equals_moves_to_strings(W, walk):
    lanes = _plain_lanes(W, W + len(walk),
                         max_steps=NQ // 2 if walk == "cut" else None)
    moves, n, si, tb, score = lanes[:5]
    rows = model_rows(*lanes)
    assert (score[[3, 11]] == 0).all() and (n[[3, 11]] == 0).all()
    if walk == "cut":
        assert (n == NQ // 2).sum() >= 4
    else:
        assert (n > NQ // 2).sum() >= 4
    head = rows[:, :24].view(np.int32)
    np.testing.assert_array_equal(head[:, :3], np.stack([score, si, tb], 1))
    for b in range(len(n)):
        want = _host_strings(moves, si, tb, *lanes[5:], b)
        assert _same(_decoded(rows[b]), want), b
        assert not rows[b, tdp.STRINGS_HEAD + n[b]:
                        tdp.STRINGS_HEAD + tdp.strings_stride(
                            moves.shape[1])].any()


def _degenerate(case):
    """One lane of hand-made moves over short codes: (moves, n, si, tb,
    score, q, qlen, t, tlen).  ``clamps``: both sides run past their
    lengths; ``wrap``: the target starts at -3, counted from the end;
    ``raises``: the target starts below -tlen; ``raises_q``: qlen 0 under
    a walk of one move."""
    fwd = {"clamps": [1, 2, 3, 1, 1, 1, 2, 1, 1, 3, 1],
           "wrap": [1, 3, 1, 2, 1],
           "raises": [1, 1, 2],
           "raises_q": [3]}[case]
    max_steps = 24
    moves = np.zeros((1, max_steps), np.uint8)
    moves[0, :len(fwd)] = fwd[::-1]
    rng = np.random.default_rng(len(case))
    q = rng.integers(0, 4, (1, 16)).astype(np.uint8)
    t = rng.integers(0, 4, (1, 32)).astype(np.uint8)
    si, tb, qlen, tlen = {"clamps": (2, 5, 6, 9), "wrap": (0, -3, 10, 12),
                          "raises": (0, -20, 10, 12),
                          "raises_q": (0, 0, 0, 12)}[case]
    return (moves, np.array([len(fwd)], np.int32), np.array([si], np.int32),
            np.array([tb], np.int32), np.array([7], np.int32), q,
            np.array([qlen], np.int32), t, np.array([tlen], np.int32))


@pytest.mark.parametrize("case", ["clamps", "wrap", "raises", "raises_q"])
def test_model_on_degenerate_walks(case):
    lanes = _degenerate(case)
    moves, n, si, tb = lanes[:4]
    rows = model_rows(*lanes)
    want = _host_strings(moves, si, tb, *lanes[5:], 0)
    assert isinstance(want, IndexError) == case.startswith("raises")
    assert _same(_decoded(rows[0]), want)
    if case == "clamps":
        qstr, tstr, qe, te = want
        assert qe > lanes[6][0] and te > lanes[8][0]   # both clamped


@pytest.fixture(scope="module")
def dataset():
    ds = make_dataset(seed=5, genome_len=6000, coverage=8, mean_read=900,
                      read_err=0.03)
    return SeqDatabase([("g", ds["genome"])]), SeqDatabase(ds["reads"][:24])


def _mesh_aligner(db, shape, device="cpu"):
    data, block = shape
    mesh = make_mesh(devices=[torch.device(device)] * (data * block),
                     block_parallel=block)
    return LongReadAligner(db, AlignerConfig(**SMALL), mesh=mesh)


def _traced(aligner, reads):
    timing.tracing()   # an untraced call: the traced stretch starts anew
    with profile(activities=[ProfilerActivity.CPU]):
        out = aligner.align_reads(reads)
    return out, timing.counts()


@pytest.fixture(autouse=True)
def fresh_registry(monkeypatch):
    monkeypatch.setattr(timing, "_counts", {})


@pytest.mark.parametrize("shape", [(1, 1), (2, 1)], ids=["1x1", "2x1"])
def test_extend_lanes_decodes_card_rows(dataset, shape, monkeypatch):
    """The records of the moves route, and of an extender that returns the
    model's rows as a card's, are the same."""
    db, reads = dataset
    moves_out, moves_c = _traced(_mesh_aligner(db, shape), reads)
    assert len(moves_out) > 0 and moves_c["extend.card_strings"] == 0
    real = tsh.make_sharded_extender

    def card_like(mesh, **kw):
        ext = real(mesh, **kw)

        def call(q, qlen, t, tlen, c0):
            e = ext(q, qlen, t, tlen, c0)
            n = np.count_nonzero(e.moves, axis=1)
            rows = model_rows(e.moves, n, e.si, e.tb, e.score, q, qlen, t,
                              tlen)
            return e._replace(card=np.ones(len(qlen), bool), strings=rows,
                              moves=None)
        return call

    def no_host_strings(*a):
        raise AssertionError("moves_to_strings on a card lane")

    monkeypatch.setattr(tsh, "make_sharded_extender", card_like)
    monkeypatch.setattr(taligner, "moves_to_strings", no_host_strings)
    rows_out, rows_c = _traced(_mesh_aligner(db, shape), reads)
    assert rows_out.to_ref_text() == moves_out.to_ref_text()
    assert rows_c["extend.card_strings"] == rows_c["extend.lanes"] > 0


def _card_lanes(W, seed, max_steps):
    """adaptive_lanes through the card's DP, traceback and strings kernels:
    (rows, moves, n, si, tb, score, q, qlen, t, tlen) on the host."""
    q, qlen, t, tlen, c0 = (torch.from_numpy(x).cuda() for x in
                            chip_smoke.adaptive_lanes(
                                np.random.default_rng(seed), 32, 1024, W))
    res = tdp.banded_align(q, qlen, t, tlen, c0, W=W, x_drop=250, **KW)
    moves, n, si, sj = tdp.traceback(res.dirs, res.centers, res.best_i,
                                     res.best_j, max_steps=max_steps)
    tb = tdp.start_column(res.centers, si, sj, W)
    rows = tdp.gapped_strings(moves, n, si, tb, res.score, q, qlen, t, tlen)
    return tuple(x.cpu().numpy() for x in (rows, moves, n, si, tb, res.score,
                                           q, qlen, t, tlen))


@pytest.mark.card
@pytest.mark.parametrize("W", [256, 2048])
def test_card_strings_equal_model(W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    NT = 1024 + 2 * W
    for max_steps in (1024 + NT, 512, 519):
        rows, *lanes = _card_lanes(W, W, max_steps)
        moves, n, si, tb = lanes[:4]
        np.testing.assert_array_equal(rows, model_rows(*lanes))
        for b in range(len(n)):
            assert _same(_decoded(rows[b]), _host_strings(
                moves, si, tb, *lanes[5:], b)), (max_steps, b)


@pytest.mark.card
def test_card_counts_card_strings(dataset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    db, reads = dataset
    launches = tdp.gapped_strings.launches
    out, c = _traced(_mesh_aligner(db, (1, 1), "cuda:0"), reads)
    assert tdp.gapped_strings.launches > launches
    assert c["extend.card_strings"] == c["extend.lanes"] > 0
    cpu_out = _mesh_aligner(db, (1, 1)).align_reads(reads)
    assert out.to_ref_text() == cpu_out.to_ref_text()
