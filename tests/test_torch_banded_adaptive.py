"""The adaptive band's plain versions (aligngraph2_tpu_torch/ops/banded_dp.py)
against the JAX package's banded_align / traceback on the lanes the card
gate uses (chip_smoke.adaptive_lanes) at small size, at every band width
the kernels take, and the pieces of the CUDA kernels' contract that run on
the CPU: the gap chain's serial form, one warp's blocked chain and a
group of warps' chain and row maximum (emulated in numpy), the DP's packed
row key and staged target span, the traceback's DIAG-run step, the
frozen-centre fill, the width check, the clocked copy's edits and the
aligner's plain route.  Every comparison is exact."""

import os
import re
from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke
from aligngraph2_tpu.ops import banded_dp as jdp
from aligngraph2_tpu_torch.align import aligner as taligner
from aligngraph2_tpu_torch.config import AlignerConfig
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
from aligngraph2_tpu_torch.ops import _cuda
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


@pytest.mark.parametrize("W,x_drop", [(16, 0), (16, 250), (32, 250),
                                      (2048, 0), (2048, 250), (4096, 0),
                                      (4096, 250)])
def test_plain_equals_jax_at_every_kernel_width(W, x_drop):
    """The widths the kernels gained (one column a thread at 16 and 32, a
    group of warps at 2048 and 4096), both forms, on the gate's lanes at
    NQ = 128: every output of the DP and the traceback at the full
    max_steps and at one that cuts walks."""
    lanes = _lanes(W, W + x_drop + 1)
    q, qlen, t, tlen, c0 = lanes
    want = jdp.banded_align(*lanes, W=W, x_drop=x_drop)
    got = tdp.banded_align_ref(*lanes, W=W, x_drop=x_drop)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.score.max()) > 100
    cut = 0
    for ms in (NQ + t.shape[1], NQ // 3):
        mj = [np.asarray(x) for x in jdp.traceback(
            want.dirs, want.centers, want.best_i, want.best_j, max_steps=ms)]
        mt = [x.numpy() for x in tdp.traceback_ref(
            got.dirs, got.centers, got.best_i, got.best_j, max_steps=ms)]
        for a, b, name in zip(mt, mj, ("moves", "n", "si", "sj")):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}@{ms}")
        cut = int((mj[1] == ms).sum())
    assert cut > 0


def _group_row(M, live, gap, W, packed):
    """dp_group's row (dp_adaptive_kernel at W = 2048 and 4096), emulated
    on G = W/1024 warps of 32 threads of 32 columns, from the row's M (R,
    W) and its live cells (R, W; an interval a row): each warp's own chain
    (serial prefix, shuffle scan, carry, fix-up), its total, its best key
    (or maximum and first column) over its live cells and its first two
    H; then, as every warp does after the barrier, the carries C_g, each
    warp's best with the carry term at its first live column (the last
    where gap > 0), the row's best, the final cells and the neighbours
    across the warp edges.  Returns (final H unmasked, final H with NEG
    cells, row max, its column, lft (R, G) of each warp's thread 0, rt0
    and rt1 (R, G) of each warp's thread 31)."""
    G, C = W // 1024, 32
    kb = tdp.key_bits(W)
    kcol = (1 << kb) - 1
    R = len(M)
    lane = np.arange(32)
    H = M.reshape(R, G, 32, C).copy()
    for k in range(1, C):
        H[..., k] = np.maximum(H[..., k - 1] + gap, H[..., k])
    x = H[..., C - 1].copy()
    for e in (1, 2, 4, 8, 16):
        y = np.roll(x, e, axis=2)
        x = np.where(lane >= e, np.maximum(y + gap * C * e, x), x)
    total = x[..., 31]
    carry = np.where(lane >= 1, np.roll(x, 1, axis=2), tdp.NEG)
    H = np.maximum(carry[..., None] + gap * (np.arange(C) + 1), H)
    Hl = H.reshape(R, G, 1024)
    lv = live.reshape(R, G, 1024)
    cols = np.arange(W).reshape(G, 1024)
    keys = np.where(lv, (Hl << kb) + kcol - cols, -1)
    vals = np.where(lv, Hl, tdp.NEG)
    out = np.empty((R, W), np.int64)
    rmax = np.empty(R, np.int64)
    rarg = np.empty(R, np.int64)
    lft = np.full((R, G), tdp.NEG, np.int64)
    rt0 = np.full((R, G), tdp.NEG, np.int64)
    rt1 = np.full((R, G), tdp.NEG, np.int64)
    for r in range(R):
        on = np.flatnonzero(live[r])
        jlo, jhi = (on[0], on[-1]) if len(on) else (W, -1)
        cin = tdp.NEG
        cins, kbest, mbest, abest = [], -1, tdp.NEG, 0
        for g in range(G):
            wa = int(keys[r, g].max()) if packed else int(vals[r, g].max())
            wb = int(np.argmax(vals[r, g])) + 1024 * g
            a, e = max(jlo, 1024 * g), min(jhi, 1024 * g + 1023)
            if g > 0 and a <= e:
                cs = a if gap <= 0 else e
                cv = cin + gap * (cs - 1024 * g + 1)
                if packed:
                    if cv >= 0:
                        wa = max(wa, (cv << kb) + kcol - cs)
                elif cv > wa or (cv == wa and cs < wb):
                    wa, wb = cv, cs
            if packed:
                kbest = max(kbest, wa)
            elif wa > mbest:
                mbest, abest = wa, wb
            cins.append(cin)
            if g > 0:
                rt0[r, g - 1] = max(Hl[r, g, 0], cin + gap)
                rt1[r, g - 1] = max(Hl[r, g, 1], cin + 2 * gap)
            cin = max(int(total[r, g]), cin + gap * 1024)
        if packed:
            rmax[r] = kbest >> kb if kbest >= 0 else tdp.NEG
            rarg[r] = kcol - (kbest & kcol)
        else:
            rmax[r], rarg[r] = mbest, abest
        for g in range(G):
            out[r, 1024 * g:1024 * (g + 1)] = np.maximum(
                Hl[r, g], cins[g] + gap * (np.arange(1024) + 1))
            if g > 0:
                lft[r, g] = cins[g]
    masked = np.where(live, out, tdp.NEG)
    for g in range(G):   # the edges' cells are live or NEG
        if g > 0:
            lft[:, g] = np.where(live[:, 1024 * g - 1], lft[:, g], tdp.NEG)
        if g < G - 1:
            rt0[:, g] = np.where(live[:, 1024 * g + 1024], rt0[:, g],
                                 tdp.NEG)
            rt1[:, g] = np.where(live[:, 1024 * g + 1025], rt1[:, g],
                                 tdp.NEG)
    return out, masked, rmax, rarg, lft, rt0, rt1


@pytest.mark.parametrize("W", [2048, 4096])
def test_group_gap_chain_and_row_max_equal_kogge_stone(W):
    """dp_group's chain and row reduction across its warps, emulated
    (_group_row): the final cells equal maxplus_scan over the shifts 1 ..
    W/2, the row maximum and its first column equal the plain rule over
    the live cells (both key forms), and each warp's edge neighbours equal
    the final row's cells there.  Rows with a peak just before a warp
    edge (the carry wins the next warp's first live column), ties across
    warps, live intervals that start, end or vanish inside a warp, rows
    of zeros, and gap 0 and 2 (the carry term flat or rising)."""
    G = W // 1024
    rng = np.random.default_rng(W)
    R = 48
    M = rng.integers(0, 30, (R, W)).astype(np.int64)
    M[rng.random(M.shape) < 0.6] = 0
    for r in range(0, R, 4):   # a peak before a warp edge
        g = int(rng.integers(1, G))
        M[r, 1024 * g - int(rng.integers(1, 40))] = 900
    M[1] = 0
    M[5, [100, 1024 + 100]] = 77   # a tie across warps
    live = np.zeros((R, W), bool)
    for r in range(R):
        lo = int(rng.integers(-W // 2, W))
        hi = int(rng.integers(lo, lo + W + W // 2))
        live[r, max(lo, 0):max(min(hi, W), 0)] = True
    live[2] = True
    live[3] = False
    live[4, 1024 + 7:] = True
    for gap in (-3, -1, -7, 0, 2):
        want = tdp.maxplus_scan(torch.from_numpy(M), gap,
                                tdp.ks_shifts(W)).numpy()
        wmask = np.where(live, want, tdp.NEG)
        wmax = wmask.max(axis=1)
        for packed in (True, False):
            out, masked, rmax, rarg, lft, rt0, rt1 = _group_row(
                M, live, gap, W, packed)
            np.testing.assert_array_equal(out, want, err_msg=str(gap))
            np.testing.assert_array_equal(masked, wmask)
            np.testing.assert_array_equal(rmax, wmax)
            on = wmax >= 0
            np.testing.assert_array_equal(rarg[on],
                                          wmask.argmax(axis=1)[on])
            for g in range(G):
                if g > 0:
                    np.testing.assert_array_equal(lft[:, g],
                                                  wmask[:, 1024 * g - 1])
                if g < G - 1:
                    np.testing.assert_array_equal(rt0[:, g],
                                                  wmask[:, 1024 * g + 1024])
                    np.testing.assert_array_equal(rt1[:, g],
                                                  wmask[:, 1024 * g + 1025])
    # the carry into a later warp decided a row's maximum
    out, masked, rmax, rarg, *_ = _group_row(M, live, -3, W, True)
    assert any(rarg[r] % 1024 < 40 and rarg[r] >= 1024 and M[r, rarg[r]] < 900
               for r in range(0, R, 4) if rmax[r] > 0)


@pytest.mark.parametrize("W", [16, 32, 64, 128, 256, 512, 1024])
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


@pytest.mark.parametrize("W", [16, 32, 64, 128, 256, 512, 1024])
def test_blocked_gap_chain_equals_kogge_stone(W):
    """dp_adaptive_kernel's gap chain, emulated on 32 threads of C = W/32
    columns (one at W = 32 and 16; at 16 threads 16 .. 31 mirror threads
    0 .. 15 and are read by none): the serial prefix over each thread's
    columns, an inclusive shuffle scan of the thread totals over shifts
    1 .. 16 (a lane with no source lane keeps its value), the carry from
    the left neighbour (NEG into lane 0), and the fix-up max(carry +
    gap*(k+1), prefix[k]), equals maxplus_scan over the shifts 1 .. W/2,
    exactly."""
    C = max(W // 32, 1)
    NL = W // C
    rng = np.random.default_rng(W + 1)
    M = rng.integers(0, 400, (16, NL, C)).astype(np.int64)
    M[rng.random(M.shape) < 0.4] = 0
    M = np.concatenate([M] * (32 // NL), axis=1)   # the mirrors
    lane = np.arange(32)
    for gap in (-3, -1, -7):
        H = M.copy()
        for k in range(1, C):
            H[:, :, k] = np.maximum(H[:, :, k - 1] + gap, M[:, :, k])
        x = H[:, :, C - 1].copy()
        for e in (1, 2, 4, 8, 16):
            y = np.roll(x, e, axis=1)   # __shfl_up_sync: lane - e
            x = np.where(lane >= e, np.maximum(y + gap * C * e, x), x)
        carry = np.where(lane >= 1, np.roll(x, 1, axis=1), tdp.NEG)
        H = np.maximum(carry[:, :, None] + gap * (np.arange(C) + 1), H)
        want = tdp.maxplus_scan(torch.from_numpy(M[:, :NL].reshape(16, W)),
                                gap, tdp.ks_shifts(W))
        np.testing.assert_array_equal(H[:, :NL].reshape(16, W),
                                      want.numpy(), err_msg=str(gap))


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
    """The CUDA path takes every power of two W from 16 to 4096 (the
    domain PipelineConfig.validate holds band_width to on cuda) and raises
    for any other band, as the static band's _need_width does."""
    assert tdp.KERNEL_WIDTHS == tuple(1 << e for e in range(4, 13))
    for e in range(4, 13):
        tdp.need_width(1 << e)
    for W in (8, 48, 96, 8192):
        with pytest.raises(ValueError, match="power of two from 16 to 4096"):
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


KERNEL_SRC = os.path.join(os.path.dirname(tdp.__file__), os.pardir, "csrc",
                          "banded_adaptive.cu")


def _kernel_constant(pattern):
    with open(KERNEL_SRC) as f:
        m = re.search(pattern, f.read())
    assert m, pattern
    return int(m.group(1))


def _row_keys(H, W):
    """dp_adaptive_kernel's row reduction on rows H (R, W): each cell's key
    h << key_bits(W) | (2^key_bits(W) - 1 - j), -1 for a NEG cell; a
    thread's C columns as a max tree (C = W/32, one at W <= 32, where
    threads past W hold only -1), the max over the 32 threads of a warp,
    and past W = 1024 the max over the W/1024 warps.  Returns (row max,
    first column) as the kernel decodes them."""
    kb = tdp.key_bits(W)
    lo = (1 << kb) - 1
    j = np.arange(W, dtype=np.int64)
    keys = np.where(H >= 0, (H.astype(np.int64) << kb) + lo - j, -1)
    assert keys.max() <= np.iinfo(np.int32).max
    C = min(max(W // 32, 1), 32)
    t = keys.reshape(len(H), -1, C)       # (rows, threads, C)
    if t.shape[1] < 32:
        t = np.concatenate([t, np.full((len(H), 32 - t.shape[1], C), -1)],
                           axis=1)
    while t.shape[2] > 1:   # the tree: pairs of neighbours
        t = np.maximum(t[:, :, 0::2], t[:, :, 1::2])
    key = t[:, :, 0].reshape(len(H), -1, 32).max(axis=2).max(axis=1)
    rmax = np.where(key >= 0, key >> kb, tdp.NEG)
    return rmax, lo - (key & lo)


@pytest.mark.parametrize("W", tdp.KERNEL_WIDTHS)
def test_packed_row_key_equals_two_reductions(W):
    """One max over the packed keys gives the row maximum and its first
    column (the two reductions of the plain rule: max, then the smallest
    column at the max), with ties, NEG cells, rows of NEG and rows at the
    largest score the bound admits; so the drift, the best cell and the
    x_drop rule read the same."""
    rng = np.random.default_rng(W)
    R = 64
    top = 1 << (31 - tdp.key_bits(W))                 # the bound
    H = rng.integers(0, 6, (R, W)).astype(np.int32)   # many ties
    H[rng.random(H.shape) < 0.3] = tdp.NEG
    H[0] = tdp.NEG                                    # a row of NEG
    H[1] = 0
    H[2, : W // 2] = tdp.NEG
    H[3] = rng.integers(0, top, W)                    # up to the bound
    H[4, [5, W - 1]] = top - 1                        # the largest, tied
    H[5, -1] = 7                                      # last column only
    rmax, rarg = _row_keys(H, W)
    np.testing.assert_array_equal(rmax, H.max(axis=1))
    live = rmax >= 0
    np.testing.assert_array_equal(rarg[live], H.argmax(axis=1)[live])
    assert rmax[0] == tdp.NEG and rarg[4] == 5 and rarg[5] == W - 1
    for best in (0, 3, 5, top // 2):
        for x_drop in (1, 2, 250):
            dies = ~((best == 0) | (rmax >= best - x_drop))
            want = ~((best == 0) | (H.max(axis=1) >= best - x_drop))
            np.testing.assert_array_equal(dies, want)


def test_packed_key_bound_picks_the_form():
    """The wrapper reduces with packed keys exactly while every key of
    max(match, 0) * NQ fits int32, else with two reductions; the
    aligner's widest bucket (NQ = 131072) at match 2 is packed."""
    W = 256
    kb = tdp.key_bits(W)
    top = (1 << (31 - kb)) - 1                     # the largest score
    assert top * (1 << kb) + (1 << kb) - 1 == np.iinfo(np.int32).max
    assert tdp.packed_key_ok(2, 131072, W)
    assert tdp.packed_key_ok(1, top, W) and not tdp.packed_key_ok(1, top + 1, W)
    assert tdp.packed_key_ok(2, top // 2, W) \
        and not tdp.packed_key_ok(2, 1 << 20, W)
    assert not tdp.packed_key_ok(16, 131072, W)
    assert tdp.packed_key_ok(0, 10 ** 9, W) and tdp.packed_key_ok(-1, 10 ** 9, W)


def test_packed_key_bound_follows_the_width():
    """The row key takes 10 column bits up to W = 1024 and log2 W past it
    (11 at 2048, 12 at 4096), in the wrapper as in the kernel's key_bits,
    so the packed form's edge falls to match * NQ < 2^(31 - log2 W) there;
    the aligner's widest bucket at match 2 stays packed at every width."""
    with open(KERNEL_SRC) as f:
        src = f.read()
    assert "return W <= 1024 ? 10 : W == 2048 ? 11 : 12;" in src
    for W in tdp.KERNEL_WIDTHS:
        kb = tdp.key_bits(W)
        assert kb == max(10, W.bit_length() - 1)
        top = (1 << (31 - kb)) - 1
        assert tdp.packed_key_ok(1, top, W)
        assert not tdp.packed_key_ok(1, top + 1, W)
        assert tdp.packed_key_ok(2, 131072, W)
    assert tdp.packed_key_ok(2, (1 << 19) - 1, 2048)
    assert not tdp.packed_key_ok(2, 1 << 19, 2048)
    assert tdp.packed_key_ok(2, (1 << 18) - 1, 4096)
    assert not tdp.packed_key_ok(2, 1 << 18, 4096)
    assert tdp.packed_key_ok(2, 1 << 19, 1024)


def test_staged_span_covers_every_drift():
    """dp_adaptive_kernel stages kStage rows' target bytes a stage ahead:
    at the start of stage k it fetches stage k + 1's SPAN bytes from
    window position base & ~15 (base_i = i - 1 + c_i - W/2 of the row just
    computed), and row i + 1 reads the words from base_i - s + j0 that
    cover its C columns at every drift.  Every drift sequence (the base
    moves 0, 1 or 2 a row) keeps every such read inside the span."""
    stage = _kernel_constant(r"constexpr int kStage = (\d+);")
    extra = _kernel_constant(r"constexpr int SPAN = W \+ (\d+);")
    rng = np.random.default_rng(0)
    n = 6 * stage
    seqs = [np.zeros(n, int), np.full(n, 2), np.tile([0, 2], n // 2),
            np.r_[np.zeros(stage, int), np.full(n - stage, 2)],
            np.r_[np.full(stage, 2), np.zeros(stage, int),
                  np.full(n - 2 * stage, 2)],
            *(rng.integers(0, 3, n) for _ in range(8))]
    # past W = 1024 each warp of the group stages its 1024 columns' span
    assert _kernel_constant(r"constexpr int SPAN = 1024 \+ (\d+);") == extra
    for W in (w for w in tdp.KERNEL_WIDTHS if w <= 1024):
        C = max(W // 32, 1)
        NA = (C + 3) // 4
        span = W + extra
        assert span % 16 == 0
        reach = 0
        for steps in seqs:
            for base0 in range(-W - 40, -W - 8):   # every residue mod 16
                base = base0 + np.r_[0, np.cumsum(steps)]
                for i in range(n):     # row i + 1 reads from base[i]
                    k = i // stage
                    s = int(base[stage * max(k - 1, 0)]) & ~15
                    o = int(base[i]) - s + np.arange(0, W, C)
                    lo = (o >> 2) * 4
                    assert o.min() >= 0
                    assert (lo + 4 * (NA + 2)).max() <= span, (W, i)
                    reach = max(reach, int((lo + 4 * (NA + 2)).max()))
        assert reach > span - 16   # the span is not loose by a chunk


@pytest.mark.parametrize("x_drop", [0, 250])
def test_window_moves_by_at_most_one_from_the_clipped_centre(x_drop):
    """The staged span rests on the window base moving 0 to 2 a row: the
    kernel measures each row's move from the clipped centre (clip(c0) for
    row 1), and c0 may lie outside [-W, c_hi] (the gate's lanes 5 and 6
    start there).  On such lanes the plain version's centres move by at
    most one from clip(c0) at row 1 and by at most one a row after."""
    W = 32
    lanes = _lanes(W, 5 + x_drop, B=16)
    c0 = lanes[4]
    NT = lanes[2].shape[1]
    c_hi = NT if x_drop else NT + 2 * W + NQ + 4
    c0[5], c0[13] = -W - 5, -W - 1       # below the clip
    if x_drop:
        c0[6], c0[14] = NT + 6, NT + 1    # above it
    res = tdp.banded_align_ref(*lanes, W=W, x_drop=x_drop)
    cen = res.centers.numpy().astype(np.int64)
    moved = np.diff(np.c_[np.clip(c0, -W, c_hi), cen[:, 1:]], axis=1)
    rows = res.best_i.numpy()   # every lane runs at least to its best row
    for b in range(len(c0)):
        assert np.abs(moved[b, :max(int(rows[b]), 1)]).max() <= 1, b


def _run_walk(dirs, centers, best_i, best_j, max_steps, tile=32):
    """tb_adaptive_kernel's walk, emulated in numpy: each warp step, lane k
    reads the byte of move k of a DIAG run from (i, j) (row min(i-1-k,
    NQ-1), column j + cen[min(i,NQ)] - cen[min(i-k,NQ)] by JAX's gather
    rule); the first non-DIAG lane r (a ballot and __ffs) gives the run;
    the step takes r DIAG moves cut by max_steps, then lane r's move (UP,
    LEFT, or the end at STOP or row 0).  Rows and centres read must lie
    in the two resident tiles (the walk's row's and the one below) or be
    centre NQ.  Returns (moves, n, si, sj) and counts of the cases hit."""
    B, NQ, W = dirs.shape
    moves = np.zeros((B, max_steps), np.uint8)
    n = np.zeros(B, np.int32)
    si = np.zeros(B, np.int32)
    sj = np.zeros(B, np.int32)
    seen = Counter()
    for b in range(B):
        i, j = int(best_i[b]), int(best_j[b])
        cen = centers[b].astype(np.int64)
        cen_hi = int(cen[min(i, NQ)]) if i > 0 else 0
        step = 0
        seen["start_i_0"] += i == 0
        seen["start_i_nq"] += i >= NQ
        while step < max_steps and i > 0:
            g = min(i - 1, NQ - 1)
            lo = (g // tile - 1) * tile
            jk, jn, code = [], [], []
            for k in range(32):
                ik = i - k

                def cen_at(x, live=ik > 0):
                    x = max(x, 0)
                    if x >= NQ:
                        return int(cen[NQ])
                    assert not live or lo <= x <= g, (x, lo, g)
                    return int(cen[x])
                ca = cen_hi if k == 0 else cen_at(ik)
                jk.append(j + cen_hi - ca)
                jn.append(j + cen_hi - cen_at(ik - 1))
                col = jk[-1] + W if jk[-1] < 0 else jk[-1]
                if ik > 0:
                    row = min(ik - 1, NQ - 1)
                    assert lo <= row <= g
                    seen["col_clamped"] += not 0 <= col < W
                    code.append(int(dirs[b, row, min(max(col, 0), W - 1)]))
                else:
                    code.append(tdp.STOP)
            nd = [k for k in range(32) if code[k] != tdp.DIAG]
            r = nd[0] if nd else 32
            take = min(r, max_steps - step)
            moves[b, step:step + take] = tdp.DIAG
            src = min(take, 31)
            step += take
            i -= take
            if take < r:
                seen["cut_in_run"] += 1
                j = jk[src]
                break
            if r == 32:
                seen["run_32"] += 1
                cen_hi += j - jn[src]
                j = jn[src]
                continue
            if code[src] == tdp.STOP or step == max_steps:
                seen["row_0_in_run" if i == 0 else "stop"] += 1
                j = jk[src]
                break
            moves[b, step] = code[src]
            step += 1
            if code[src] == tdp.LEFT:
                cen_hi += j - jk[src]
                j = jk[src] - 1
            else:
                cen_hi += j - jn[src]
                j = jn[src] + 1
                i -= 1
        n[b], si[b], sj[b] = step, i, j
    return moves, n, si, sj, seen


@pytest.mark.parametrize("W", [32, 64])
def test_run_step_walk_equals_traceback(W):
    """The DIAG-run walk equals traceback_ref and the JAX package's
    traceback on the gate's lanes (lane 7 one DIAG run from row NQ),
    with start cells moved to row NQ, row 0 and both band edges, at
    max_steps NQ + NT, NQ/2 and NQ/2 + 7: walks cut inside a run, runs
    of 32, runs that reach row 0, columns past either edge."""
    lanes = chip_smoke.diag_lane(_lanes(W, 11 * W, B=24), W)
    NT = lanes[2].shape[1]
    res = tdp.banded_align_ref(*lanes, W=W, x_drop=20)
    assert int(res.best_i[chip_smoke.DIAG_LANE]) == NQ
    dirs, centers = res.dirs.numpy(), res.centers.numpy()
    bi, bj = res.best_i.numpy().copy(), res.best_j.numpy().copy()
    bi[8], bj[8] = NQ, W // 2 + 3
    bi[9] = 0
    bj[10], bj[11] = 0, W - 1
    bi[12], bj[12] = bi[1], -2
    seen = Counter()
    for ms in (NQ + NT, NQ // 2, NQ // 2 + 7):
        *got, hit = _run_walk(dirs, centers, bi, bj, ms)
        seen.update(hit)
        want = tdp.traceback_ref(res.dirs, res.centers, torch.from_numpy(bi),
                                 torch.from_numpy(bj), max_steps=ms)
        jw = jdp.traceback(np.asarray(dirs), np.asarray(centers), bi, bj,
                           max_steps=ms)
        for a, b, c, name in zip(got, want, jw, ("moves", "n", "si", "sj")):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=f"{name}@{ms}")
            np.testing.assert_array_equal(a, np.asarray(c),
                                          err_msg=f"jax {name}@{ms}")
    for case in ("cut_in_run", "run_32", "row_0_in_run", "stop",
                 "col_clamped", "start_i_0", "start_i_nq"):
        assert seen[case] > 0, (case, seen)


def test_variant_edits_apply_to_the_kernel_source():
    """chip_smoke.py's adaptive gate builds a clock64() copy of
    csrc/banded_adaptive.cu by text edits (ADAPTIVE_CLOCK_EDITS), each
    inside the function of its form of a lane: each edit's text occurs
    exactly once there, so an edit of the kernel that moves one fails here
    rather than on the card; the copy has every phase's mark and the C
    function that reads them, and names each form's phases."""
    with open(_cuda.ADAPTIVE_SRC) as f:
        src = f.read()
    clocked = chip_smoke.clocked_adaptive_source(src)
    marks = re.findall(r"CLK\((\d)\);", clocked)
    assert len(marks) == sum(len(v) for v in
                             chip_smoke.ADAPTIVE_PHASES.values())
    for form, edits in chip_smoke.ADAPTIVE_CLOCK_EDITS.items():
        first, after = chip_smoke.ADAPTIVE_CLOCK_REGIONS[form]
        part = clocked[clocked.index(first):clocked.index(after)]
        n = len(chip_smoke.ADAPTIVE_PHASES[form])
        assert sorted(set(re.findall(r"CLK\((\d)\);", part))) == \
            [str(k) for k in range(n)], form
        assert part.count("g_clk[15] = i;") == 1, form
    assert "agc_read_clk" in clocked
    with pytest.raises(ValueError):
        chip_smoke.clocked_adaptive_source(src.replace(
            "    int x = H[C - 1];\n", "    int x = H[C - 1]; \n"))
