"""The adaptive band's plain versions (aligngraph2_tpu_torch/ops/banded_dp.py)
against the JAX package's banded_align / traceback on the lanes the card
gate uses (chip_smoke.adaptive_lanes) at small size, and the pieces of the
CUDA kernels' contract that run on the CPU: the gap chain's serial form,
the frozen-centre fill, the width check and the aligner's plain route.
Every comparison is exact."""

import numpy as np
import pytest
import torch

import chip_smoke
from aligngraph2_tpu.ops import banded_dp as jdp
from aligngraph2_tpu_torch.align import aligner as taligner
from aligngraph2_tpu_torch.config import AlignerConfig
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
from aligngraph2_tpu_torch.ops import banded_dp as tdp
from aligngraph2_tpu_torch.ops.seedextend import Candidate
from tests.synth import mutate, random_genome

torch.set_num_threads(1)

NQ = 128


def _lanes(W, seed, B=16):
    return chip_smoke.adaptive_lanes(np.random.default_rng(seed), B, NQ, W)


@pytest.mark.parametrize("W,x_drop", [(32, 0), (32, 20), (64, 0), (64, 20)])
def test_plain_equals_jax_on_gate_lanes(W, x_drop):
    """Both forms, on drift lanes, clustered x_drop deaths, short reads in
    short windows and c0 at both clips; the traceback at the full
    max_steps and at one that cuts the longer walks."""
    lanes = _lanes(W, W + x_drop)
    q, qlen, t, tlen, c0 = lanes
    assert (qlen < NQ).any() and (tlen < t.shape[1]).any()
    assert c0.min() < -W // 2 and c0.max() > t.shape[1] - 16
    want = jdp.banded_align(*lanes, W=W, x_drop=x_drop)
    got = tdp.banded_align_ref(*lanes, W=W, x_drop=x_drop)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    moved = np.abs(np.asarray(want.centers)[:, 1:] - c0[:, None])
    assert moved[::8].max() > W // 2    # the planted drift moved the band
    cut = 0
    for ms in (NQ + t.shape[1], NQ // 3):
        mj = [np.asarray(x) for x in jdp.traceback(
            want.dirs, want.centers, want.best_i, want.best_j, max_steps=ms)]
        mt = [x.numpy() for x in tdp.traceback_ref(
            got.dirs, got.centers, got.best_i, got.best_j, max_steps=ms)]
        for a, b, name in zip(mt, mj, ("moves", "n", "si", "sj")):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}@{ms}")
        cut = int((mj[1] == ms).sum())
    assert cut > 0    # NQ/3 cut some walks short


@pytest.mark.parametrize("W", [64, 128, 256, 512, 1024])
def test_serial_prefix_equals_kogge_stone(W):
    """The kernels' gap chain rests on this: the serial max-plus prefix
    H[j] = max(M[j], H[j-1] + gap) over a DP row (M >= 0 after the clamp)
    equals maxplus_scan over the shifts 1 .. W/2, exactly."""
    rng = np.random.default_rng(W)
    M = rng.integers(0, 60, (32, W)).astype(np.int32)
    M[rng.random(M.shape) < 0.3] = 0
    for gap in (-3, -1, -7):
        H = M.copy()
        for j in range(1, W):
            H[:, j] = np.maximum(H[:, j], H[:, j - 1] + gap)
        want = tdp.maxplus_scan(torch.from_numpy(M), gap, tdp.ks_shifts(W))
        np.testing.assert_array_equal(H, want.numpy(), err_msg=str(gap))


QLENS = np.array([0, 1, 17, 40, 63, 64, 100, NQ], np.int32)


def _planted_lanes(W, rng):
    """Planted reads on long windows, qlen from 0 to NQ: no row of theirs
    is all NEG, so at x_drop 10**6 each lane runs max(1, qlen) rows."""
    B = 8
    NT = NQ + 2 * W
    q = np.zeros((B, NQ), np.uint8)
    t = rng.integers(0, 4, (B, NT)).astype(np.uint8)
    qlen = QLENS.copy()
    for b in range(B):
        q[b] = chip_smoke.drifted_read(rng, t[b], W, NQ, 0.05, 0.01, 0.01)
        q[b, qlen[b]:] = 0
    return q, qlen, t, np.full(B, NT, np.int32), np.full(B, W, np.int32)


@pytest.mark.parametrize("x_drop", [0, 10 ** 6])
def test_fill_centers_restores_frozen_rows(x_drop):
    """The kernel writes each lane's centres up to its last row and
    fill_centers writes the rest: zeroing the plain output's centres past
    each lane's last row and filling them gives it back.  The last row is
    min(NQ, qlen + 1) at x_drop 0 and max(1, qlen) at x_drop 10**6 on
    these lanes."""
    W = 32
    rng = np.random.default_rng(7)
    lanes = (_planted_lanes(W, rng) if x_drop
             else chip_smoke.adaptive_lanes(rng, 16, NQ, W))
    lanes[1][:len(QLENS)] = QLENS
    res = tdp.banded_align_ref(*lanes, W=W, x_drop=x_drop)
    qlen = torch.from_numpy(lanes[1])
    rows = (qlen.clamp(min=1) if x_drop
            else (qlen.clamp(min=0) + 1)).clamp(max=NQ).to(torch.int32)
    assert len(set(rows.tolist())) > 4
    c_last = res.centers.gather(1, rows[:, None].long())[:, 0]
    idx = torch.arange(NQ + 1)[None, :]
    cut = torch.where(idx > rows[:, None], 0, res.centers)
    got = tdp.fill_centers(cut, rows, c_last, x_drop)
    assert torch.equal(got, res.centers)
    if x_drop:   # frozen rows up to the batch's last row, zero after
        assert (res.centers[:, int(rows.max()) + 1:] == 0).all()


def test_kernel_width_check():
    """The CUDA path takes W in KERNEL_WIDTHS and raises for any other
    band, as the static band's _need_width does."""
    for W in tdp.KERNEL_WIDTHS:
        tdp.need_width(W)
    assert tdp.KERNEL_WIDTHS == (64, 128, 256, 512, 1024)
    for W in (16, 32, 48, 96, 2048):
        with pytest.raises(ValueError):
            tdp.need_width(W)


@pytest.mark.parametrize("plain", [True, False])
def test_extend_batch_plain_takes_plain_versions(plain, monkeypatch):
    """_extend_batch (the long reads' route) takes banded_align_ref /
    traceback_ref under plain=True, so a plain run never launches the
    adaptive kernels; otherwise it takes the wrappers."""
    rng = np.random.default_rng(3)
    genome = random_genome(rng, 1500)
    read = mutate(rng, genome[400:900], 0.03, 0.01, 0.01)
    db = SeqDatabase([("g", genome)])
    reads = SeqDatabase([("r", read)])
    cfg = AlignerConfig(band_width=32)
    al = taligner.LongReadAligner(db, cfg, device="cpu", band="static",
                                  plain=plain)
    calls = {}
    for name in ("banded_align", "banded_align_ref", "traceback",
                 "traceback_ref"):
        fn = getattr(taligner, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(taligner, name, counted)
    codes = reads.get_codes(0)
    batch = [(0, Candidate(tid=0, forward=True, diag=400, hits=10,
                           score=10.0), codes)]
    out = taligner.AlignmentSet()
    best = {}
    nq = 512
    al._extend_batch(reads, batch, nq, nq + 2 * cfg.band_width, out, best)
    want = ({"banded_align_ref": 1, "traceback_ref": 1} if plain
            else {"banded_align": 1, "traceback": 1})
    assert calls == want
    assert len(out) == 1 and out.alignments[0].qe - out.alignments[0].qb \
        > 450
