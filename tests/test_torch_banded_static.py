"""The port's static-band DP and traceback, plain torch versions
(aligngraph2_tpu_torch/ops/banded_static.py), against the JAX package's
Pallas kernel in interpret mode and its traceback_t, on the same numpy
inputs, at the shapes of tests/test_banded_pallas.py with 16-row chunks;
the widths past 1024 against a row-by-row numpy model of the band, which
is itself held to the Pallas kernel.  Every comparison is exact.  The
CUDA kernels behind the same wrappers are held against these plain
versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from aligngraph2_tpu.io.seqdb import encode_seq, decode_seq
from aligngraph2_tpu.ops import banded_pallas as jp
from aligngraph2_tpu_torch.ops import banded_dp as tdp
from aligngraph2_tpu_torch.ops import banded_static as ts
from aligngraph2_tpu_torch.ops.banded_dp import DIAG, LEFT, STOP, UP
from tests.synth import random_genome, mutate

torch.set_num_threads(1)

# K = 16 rows a Pallas chunk: the interpret-mode kernel unrolls its rows,
# so from a cold compile cache the planted fixture's two compiles take
# minutes at K = 32 and seconds at 16
NQ, W, K, TB = 256, 128, 16, 8


def _planted(seed, B=8):
    """Reads planted in random genomes at their seed diagonal, as in
    tests/test_banded_pallas.py, with qlen < NQ."""
    rng = np.random.default_rng(seed)
    q = np.full((B, NQ), jp.Q_SENTINEL, np.uint8)
    qlen = np.zeros(B, np.int32)
    ts_, diags = [], []
    for b in range(B):
        g = encode_seq(random_genome(rng, 800))
        start = int(rng.integers(0, 400))
        ln = int(rng.integers(120, 256))
        read = encode_seq(mutate(rng, decode_seq(g[start:start + ln]),
                                 sub=0.05, ins=0.02, dele=0.02))[:NQ]
        q[b, :len(read)] = read
        qlen[b] = len(read)
        ts_.append(g)
        diags.append(start)
    t, _ = jp.standard_frame_windows(ts_, diags, NQ, W)
    return q, t, qlen


@pytest.fixture(scope="module")
def planted():
    q, t, qlen = _planted(11)
    jax_res = {xd: jp.banded_align_pallas(q, t, qlen, W=W, K=K, TB=TB,
                                          x_drop=xd, interpret=True)
               for xd in (0, 250)}
    return q, t, qlen, jax_res


def _port_dp(q, t, qlen, x_drop):
    return ts.banded_dp_static(
        torch.from_numpy(q), torch.from_numpy(t),
        None if qlen is None else torch.from_numpy(qlen), W=W, K=K,
        x_drop=x_drop)


def _jax_dirs(res):
    """Pallas (NQ/16, W, B) words -> (B, NQ, W) direction codes."""
    return np.asarray(jp.unpack_words(res.words)).transpose(2, 0, 1)


@pytest.mark.parametrize("x_drop", [0, 250])
def test_dp_equals_pallas(planted, x_drop):
    q, t, qlen, jax_res = planted
    want = jax_res[x_drop]
    got = _port_dp(q, t, qlen, x_drop)
    for name in ("score", "best_i", "best_j"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.score.min()) > 100
    dj = _jax_dirs(want)
    dt = ts.unpack_words(got.words).numpy()
    if x_drop == 0:
        np.testing.assert_array_equal(dt, dj)
        assert (got.rows.numpy() == NQ).all()
    else:
        # rows at or above best_i are written by both; a lane may stop
        # earlier here (per-lane x_drop) than in its Pallas tile
        for b in range(len(q)):
            bi = int(got.best_i[b])
            np.testing.assert_array_equal(dt[b, :bi], dj[b, :bi])
        # planted lanes die only past qlen, after the chunk holding it
        np.testing.assert_array_equal(
            got.rows.numpy(), np.minimum((qlen + K - 1) // K * K, NQ))


def test_xdrop_short_lanes_stop_early():
    """Lanes whose queries end early stop after the K-row chunk holding
    qlen, with the results of the full run."""
    rng = np.random.default_rng(4)
    g = encode_seq(random_genome(rng, 600))
    B = 4
    q = np.full((B, NQ), jp.Q_SENTINEL, np.uint8)
    qlen = np.full(B, NQ, np.int32)
    diags = []
    for b in range(B):
        ln = 40 + 30 * b
        q[b, :ln] = g[100 + 10 * b:100 + 10 * b + ln]
        qlen[b] = ln
        diags.append(100 + 10 * b)
    t, _ = jp.standard_frame_windows([g] * B, diags, NQ, W)
    full = _port_dp(q, t, qlen, 0)
    xd = _port_dp(q, t, qlen, 100)
    np.testing.assert_array_equal(xd.score.numpy(), 2 * qlen)
    np.testing.assert_array_equal(xd.best_i.numpy(), qlen)
    for name in ("score", "best_i", "best_j"):
        np.testing.assert_array_equal(getattr(xd, name).numpy(),
                                      getattr(full, name).numpy())
    np.testing.assert_array_equal(xd.rows.numpy(),
                                  (qlen + K - 1) // K * K)


def test_sentinel_lanes_score_zero():
    q = np.full((3, NQ), jp.Q_SENTINEL, np.uint8)
    t = np.full((3, NQ + W), jp.T_SENTINEL, np.uint8)
    t[1] = np.random.default_rng(0).integers(0, 4, NQ + W)
    q[2, :NQ // 2] = t[1, W // 2:W // 2 + NQ // 2]     # query, no target
    res = _port_dp(q, t, None, 0)
    for name in ("score", "best_i", "best_j"):
        assert not getattr(res, name).any(), name


@pytest.mark.parametrize("max_steps", [2 * NQ, 100, 32, 15])
def test_traceback_equals_traceback_t(max_steps):
    """The plain traceback against traceback_t on the Pallas kernel's own
    words, including truncation at max_steps (tests/test_banded_pallas.py
    :122)."""
    rng = np.random.default_rng(2)
    Wt, B = 64, 8
    q = np.full((B, NQ), jp.Q_SENTINEL, np.uint8)
    ts_ = []
    for b in range(B):
        g = encode_seq(random_genome(rng, NQ + 50))
        read = encode_seq(mutate(rng, decode_seq(g[:NQ]), 0.12))[:NQ]
        q[b, :len(read)] = read
        ts_.append(g)
    t, _ = jp.standard_frame_windows(ts_, [0] * B, NQ, Wt)
    res = jp.banded_align_pallas(q, t, W=Wt, K=K, TB=TB, interpret=True)
    want = jp.traceback_t(res.words, res.best_i, res.best_j,
                          max_steps=max_steps, W=Wt)
    words = torch.from_numpy(np.ascontiguousarray(
        np.asarray(res.words).transpose(2, 0, 1)))
    got = ts.traceback_static(words, torch.tensor(np.asarray(res.best_i)),
                              torch.tensor(np.asarray(res.best_j)),
                              max_steps=max_steps)
    for a, b, name in zip(got, want, ("moves", "n", "si", "sj")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    # and the port's own DP feeds it the same words
    mine = ts.banded_dp_static(torch.from_numpy(q), torch.from_numpy(t),
                               W=Wt, K=K)
    np.testing.assert_array_equal(ts.unpack_words(mine.words).numpy(),
                                  _jax_dirs(res))


def test_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors run the plain versions without counting a launch; any
    other device goes to the kernel path, which checks its inputs."""
    n_dp = ts.banded_dp_static.launches
    n_tb = ts.traceback_static.launches
    q = torch.full((2, 32), ts.Q_SENTINEL, dtype=torch.uint8)
    t = torch.full((2, 32 + 32), ts.T_SENTINEL, dtype=torch.uint8)
    res = ts.banded_dp_static(q, t, W=32, K=16)
    ts.traceback_static(res.words, res.best_i, res.best_j, max_steps=8)
    assert ts.banded_dp_static.launches == n_dp
    assert ts.traceback_static.launches == n_tb
    with pytest.raises(ValueError, match="CUDA tensor"):
        ts.banded_dp_static(q.to("meta"), t.to("meta"), W=32, K=16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ts.traceback_static(res.words.to("meta"), res.best_i.to("meta"),
                            res.best_j.to("meta"), max_steps=8)


def test_xdrop_per_lane_rule_diverges_only_on_recovering_lanes():
    """The one place the port leaves the Pallas kernel on purpose:
    x_drop per lane instead of per tile, measured as a lane count.  Half
    the lanes carry a random stretch after a short planted start, die in
    it, and would recover on the longer planted tail.  The Pallas tile
    keeps them computing (their tile-mates live), so they recover there;
    here they stop.  Exactly those lanes differ.  Small shapes: each new
    x_drop value costs an interpret-mode compile."""
    nq, w, k, xd = 128, 32, 16, 20
    rng = np.random.default_rng(8)
    B = 8
    t = rng.integers(0, 4, (B, nq + w)).astype(np.uint8)
    q = t[:, w // 2:w // 2 + nq].copy()
    noise = rng.random((B, nq)) < 0.05
    q[noise] = rng.integers(0, 4, int(noise.sum()))
    q[1::2, 32:80] = rng.integers(0, 4, (B // 2, 48))
    qlen = np.full(B, nq, np.int32)
    tile = jp.banded_align_pallas(q, t, qlen, W=w, K=k, TB=TB, x_drop=xd,
                                  interpret=True)
    args = [torch.from_numpy(x) for x in (q, t, qlen)]
    full = ts.banded_dp_static(*args, W=w, K=k)
    lane = ts.banded_dp_static(*args, W=w, K=k, x_drop=xd)
    # the tile rule kept every lane computing: all equal the full run
    for name in ("score", "best_i", "best_j"):
        np.testing.assert_array_equal(np.asarray(getattr(tile, name)),
                                      getattr(full, name).numpy())
    differ = np.flatnonzero((lane.score != full.score).numpy())
    np.testing.assert_array_equal(differ, [1, 3, 5, 7])
    assert (lane.rows.numpy()[differ] <= 80).all()
    assert (lane.rows.numpy()[::2] == nq).all()


def _blocked_maxplus_scan(M, gap):
    """The DP kernel's gap chain, step by step: thread l of the warp owns
    the C = W/32 columns [lC, lC + C); a serial max-plus prefix over them,
    a 5-step shuffle scan of the thread totals with weight gap*C*d (lanes
    below d keep their value, as after __shfl_up_sync), the exclusive carry
    of the previous thread (NEG for thread 0), then the fix-up
    v[c] = max(v[c], carry + gap*(c+1))."""
    R, Wd = M.shape
    C = Wd // 32
    v = M.reshape(R, 32, C).clone()
    for c in range(1, C):
        v[:, :, c] = torch.maximum(v[:, :, c], v[:, :, c - 1] + gap)
    lane = torch.arange(32)[None, :]
    x = v[:, :, C - 1].clone()
    d = 1
    while d < 32:
        y = torch.nn.functional.pad(x[:, :-d], (d, 0), value=tdp.NEG)
        x = torch.where(lane >= d, torch.maximum(x, y + gap * C * d), x)
        d <<= 1
    carry = torch.nn.functional.pad(x[:, :-1], (1, 0), value=tdp.NEG)
    fix = carry[:, :, None] + gap * (torch.arange(C) + 1)[None, None, :]
    return torch.maximum(v, fix).reshape(R, Wd)


@pytest.mark.parametrize("Wd", [32, 64, 128, 256, 512, 1024])
def test_blocked_gap_chain_equals_kogge_stone(Wd):
    """The kernel's blocked gap chain equals the Kogge-Stone max-plus scan
    of the plain versions (and of the Pallas kernel) exactly, on random
    rows with runs of zeros and of NEG."""
    rng = np.random.default_rng(Wd)
    R = 64
    M = rng.integers(0, 80, (R, Wd)).astype(np.int32)
    for r in range(R):
        a, b = sorted(rng.integers(0, Wd, 2))
        M[r, a:b] = 0 if r % 2 else tdp.NEG
    M[rng.random((R, Wd)) < 0.05] = tdp.NEG
    M[0] = tdp.NEG
    M[1] = 0
    M = torch.from_numpy(M)
    for gap in (-3, -1, -7):
        want = tdp.maxplus_scan(M, gap, tdp.ks_shifts(Wd))
        assert torch.equal(_blocked_maxplus_scan(M, gap), want), gap


def _words_from_dirs(dirs):
    """(B, NQ, W) direction codes -> the port's (B, NQ/16, W) int32 words
    and the Pallas kernel's (NQ/16, W, B) layout."""
    B, nq, w = dirs.shape
    d = dirs.astype(np.uint32).reshape(B, nq // 16, 16, w)
    words = np.zeros((B, nq // 16, w), np.uint32)
    for s in range(16):
        words |= d[:, :, s, :] << np.uint32(2 * s)
    words = words.view(np.int32)
    return words, np.ascontiguousarray(words.transpose(1, 2, 0))


def _edge_case(name, rng):
    """Direction codes, best cells and max_steps that drive the walk to
    one edge of the band or of the word layout."""
    nq, w, B = 64, 32, 4
    dirs = rng.choice([DIAG] * 6 + [UP, LEFT, STOP], (B, nq, w))
    bi = np.array([40, 20, 50, 33], np.int32)
    bj = np.array([5, 3, 9, 17], np.int32)
    max_steps = 2 * nq + w
    if name == "left_run_to_col0":
        dirs[0, 39, 1:6] = LEFT       # left to column 0, then down it
        dirs[0, :39, 0] = DIAG
        dirs[1, 19, 0:4] = LEFT       # left past column 0: j < 0 reads col 0
        dirs[2, 49, :10] = LEFT
        dirs[2, :49, 0] = UP          # up from column 0
    elif name == "up_at_last_col":
        bj[:] = [w - 1, w - 2, w - 1, w - 1]
        dirs[0, 10:40, w - 1] = UP    # j passes W-1: reads column W-1
        dirs[1, 19, w - 2] = UP
        dirs[1, :19, w - 1] = DIAG
        dirs[2, 49, w - 1] = LEFT
        dirs[2, 48, w - 2] = UP
    elif name == "max_steps_cut":
        dirs = rng.choice([DIAG, UP, LEFT], (B, nq, w))
        max_steps = 17
    elif name == "best_i_on_16_boundary":
        bi[:] = [16, 32, 48, nq]      # the walk starts on bit 30 of a word
        dirs[:, 15::16, :] = rng.choice([DIAG, UP, LEFT], (B, nq // 16, w))
    return dirs, bi, bj, max_steps


@pytest.mark.parametrize("name", ["left_run_to_col0", "up_at_last_col",
                                  "max_steps_cut", "best_i_on_16_boundary"])
def test_traceback_edges_equal_traceback_t(name):
    """The plain traceback (which the CUDA kernel is held against on the
    card) against traceback_t where the walk meets an edge: a LEFT run to
    and past column 0, UP moves at column W-1, a walk cut by max_steps, a
    start on a 16-row word boundary."""
    dirs, bi, bj, max_steps = _edge_case(name, np.random.default_rng(3))
    words, jwords = _words_from_dirs(dirs)
    want = jp.traceback_t(jwords, bi, bj, max_steps=max_steps,
                          W=dirs.shape[2])
    got = ts.traceback_static(torch.from_numpy(words), torch.from_numpy(bi),
                              torch.from_numpy(bj), max_steps=max_steps)
    for a, b, what in zip(got, want, ("moves", "n", "si", "sj")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=what)
    assert int(got[1].min()) > 0
    if name == "left_run_to_col0":
        assert int(got[3][1]) < 0 and int(got[3][0]) == 0
    if name == "up_at_last_col":
        assert (got[0][0, :30] == UP).all()   # j runs to W-1 + 30
    if name == "max_steps_cut":
        assert (got[1].numpy() == max_steps).all()


def _model_dp(q, t, qlen, Wd, k, x_drop, match=2, mismatch=-4, gap=-3):
    """Row-by-row numpy model of the static band: the Pallas kernel's
    recurrence and best cell, with x_drop per lane as the port decides
    it.  Row i of lane b reads q[b, i-1], its cell j reads t[b, i-1+j];
    M = max(diag + s, up + gap) with up past column W-1 absent, the cell
    STOP when M <= 0 (then M = 0), else DIAG, which wins ties, or UP;
    the left chain H[j] = max over c <= j of M[c] + gap (j - c), written
    in closed form, LEFT where it raised the cell strictly.  Per column
    the first row reaching its maximum; the best cell is the earliest
    such row of the largest value, then the smallest column, (0, 0) at
    score 0.  Every k rows before the last a lane lives iff row i+1 <=
    qlen and (best = 0 or max_j H >= best - x_drop); a dead lane keeps
    its values and writes STOP rows.  Returns (score, best_i, best_j,
    rows, dirs (B, NQ, W))."""
    B, nq = q.shape
    cols = np.arange(Wd)
    H = np.zeros((B, Wd), np.int64)
    bcol = np.zeros((B, Wd), np.int64)
    brow = np.zeros((B, Wd), np.int64)
    dirs = np.zeros((B, nq, Wd), np.uint8)
    alive = np.ones(B, bool)
    rows = np.full(B, nq)
    for i in range(1, nq + 1):
        live = alive[:, None]
        s = np.where(t[:, i - 1 + cols] == q[:, i - 1, None], match,
                     mismatch)
        diag = H + s
        up = np.concatenate([H[:, 1:] + gap, np.full((B, 1), -(1 << 40))],
                            axis=1)
        M = np.maximum(diag, up)
        code = np.where(M > 0, np.where(diag >= up, DIAG, UP), STOP)
        M = np.maximum(M, 0)
        Hn = np.maximum.accumulate(M - gap * cols, axis=1) + gap * cols
        code = np.where(Hn > M, LEFT, code)
        dirs[:, i - 1] = np.where(live, code, STOP)
        upd = live & (Hn > bcol)
        bcol = np.where(upd, Hn, bcol)
        brow = np.where(upd, i, brow)
        H = np.where(live, Hn, H)
        if x_drop > 0 and i % k == 0 and i < nq:
            best = bcol.max(axis=1)
            ok = (i + 1 <= qlen) & ((best == 0)
                                    | (H.max(axis=1) >= best - x_drop))
            died = alive & ~ok
            rows[died] = i
            alive &= ~died
    score = bcol.max(axis=1)
    top = bcol == score[:, None]
    best_i = np.where(top, brow, 1 << 30).min(axis=1)
    best_j = np.where(top & (brow == best_i[:, None]), cols, Wd).min(axis=1)
    best_i = np.where(score > 0, best_i, 0)
    best_j = np.where(score > 0, best_j, 0)
    return score, best_i, best_j, rows, dirs


def _model_walk(dirs, best_i, best_j, max_steps):
    """The traceback over model directions, one lane at a time: from the
    best cell, DIAG keeps j, UP moves to j+1, LEFT to j-1 on the same
    row (a column outside the band reads its nearest edge column); it
    stops at STOP, at row 0 or after max_steps moves.  Returns (moves
    END->START (B, max_steps), count, start row, start column)."""
    B, _, Wd = dirs.shape
    moves = np.zeros((B, max_steps), np.uint8)
    n, si, sj = (np.zeros(B, np.int64) for _ in range(3))
    for b in range(B):
        i, j = int(best_i[b]), int(best_j[b])
        for step in range(max_steps):
            cur = dirs[b, i - 1, min(max(j, 0), Wd - 1)] if i > 0 else STOP
            if cur == STOP:
                break
            moves[b, step] = cur
            n[b] += 1
            if cur == LEFT:
                j -= 1
            else:
                i -= 1
                j += cur == UP
        si[b], sj[b] = i, j
    return moves, n, si, sj


def _wide_lanes(Wd, nq=64, B=8):
    """B reads of up to nq bases planted in random genomes, their windows
    in the standard frame at the seed diagonal moved by up to W/4: (q, t,
    qlen), qlen from nq/2 to the read's length."""
    rng = np.random.default_rng(Wd)
    q = np.full((B, nq), jp.Q_SENTINEL, np.uint8)
    qlen = np.zeros(B, np.int32)
    ts_, diags = [], []
    for b in range(B):
        g = encode_seq(random_genome(rng, Wd + 400))
        start = int(rng.integers(0, Wd + 300 - nq))
        read = encode_seq(mutate(rng, decode_seq(g[start:start + nq]),
                                 sub=0.05, ins=0.03, dele=0.03))[:nq]
        ln = int(rng.integers(nq // 2, len(read) + 1))
        q[b, :ln] = read[:ln]
        qlen[b] = ln
        ts_.append(g)
        diags.append(start + int(rng.integers(-Wd // 4, Wd // 4)))
    t, _ = jp.standard_frame_windows(ts_, diags, nq, Wd)
    return q, t, qlen


@pytest.mark.parametrize("x_drop", [0, 250])
def test_model_equals_pallas(x_drop):
    """The numpy model against the Pallas kernel in interpret mode and
    traceback_t at W = 256 (K = 16, NQ = 64: the interpret-mode compile
    takes seconds, not minutes): score and best cell exact, every
    direction at x_drop 0, the rows up to best_i at 250 (a Pallas lane
    computes on while its tile lives), and every walk."""
    Wd, nq = 256, 64
    q, t, qlen = _wide_lanes(Wd, nq)
    want = jp.banded_align_pallas(q, t, qlen, W=Wd, K=K, TB=TB,
                                  x_drop=x_drop, interpret=True)
    score, best_i, best_j, rows, dirs = _model_dp(q, t, qlen, Wd, K, x_drop)
    for got, name in ((score, "score"), (best_i, "best_i"),
                      (best_j, "best_j")):
        np.testing.assert_array_equal(got, np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(score.min()) > 30
    dj = _jax_dirs(want)
    for b in range(len(q)):
        last = nq if x_drop == 0 else int(best_i[b])
        np.testing.assert_array_equal(dirs[b, :last], dj[b, :last])
    ms = 2 * nq + Wd
    tw = jp.traceback_t(want.words, want.best_i, want.best_j, max_steps=ms,
                        W=Wd)
    for a, b, name in zip(_model_walk(dirs, best_i, best_j, ms), tw,
                          ("moves", "n", "si", "sj")):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("Wd, x_drop", [(2048, 0), (2048, 250),
                                        (4096, 0), (4096, 250)])
def test_wide_band_equals_model(Wd, x_drop):
    """The widths past one warp's registers (the kernel's multi-warp
    lane): the plain DP and traceback against the numpy model, which
    test_model_equals_pallas holds to the Pallas kernel: score, best
    cell, rows run, every direction and every walk exact."""
    nq = 64
    q, t, qlen = _wide_lanes(Wd, nq)
    score, best_i, best_j, rows, dirs = _model_dp(q, t, qlen, Wd, K, x_drop)
    got = ts.banded_dp_static(torch.from_numpy(q), torch.from_numpy(t),
                              torch.from_numpy(qlen), W=Wd, K=K,
                              x_drop=x_drop)
    for want, name in ((score, "score"), (best_i, "best_i"),
                       (best_j, "best_j"), (rows, "rows")):
        np.testing.assert_array_equal(getattr(got, name).numpy(), want,
                                      err_msg=name)
    assert int(score.min()) > 40
    if x_drop:
        assert (rows < nq).any()    # some lane stopped past its qlen
    np.testing.assert_array_equal(ts.unpack_words(got.words).numpy(), dirs)
    ms = 2 * nq + Wd
    tt = ts.traceback_static(got.words, got.best_i, got.best_j,
                             max_steps=ms)
    for a, b, name in zip(tt, _model_walk(dirs, best_i, best_j, ms),
                          ("moves", "n", "si", "sj")):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.slow
@pytest.mark.parametrize("Wd, x_drop", [(4096, 250)])
def test_wide_band_equals_pallas(Wd, x_drop):
    """The widest band against the Pallas kernel itself in interpret mode
    and traceback_t (B = 8, NQ = 64): score and best cell exact, the rows
    up to best_i, and the moves, count and start of every walk.  Slow: the
    interpret-mode compile at W = 4096 takes many minutes from a cold
    cache; test_wide_band_equals_model covers the width in tier 1."""
    nq = 64
    q, t, qlen = _wide_lanes(Wd, nq)
    want = jp.banded_align_pallas(q, t, qlen, W=Wd, K=K, TB=TB,
                                  x_drop=x_drop, interpret=True)
    got = ts.banded_dp_static(torch.from_numpy(q), torch.from_numpy(t),
                              torch.from_numpy(qlen), W=Wd, K=K,
                              x_drop=x_drop)
    for name in ("score", "best_i", "best_j"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.score.min()) > 40
    dj = _jax_dirs(want)
    dt = ts.unpack_words(got.words).numpy()
    for b in range(len(q)):
        last = nq if x_drop == 0 else int(got.best_i[b])
        np.testing.assert_array_equal(dt[b, :last], dj[b, :last])
    ms = 2 * nq + Wd
    tw = jp.traceback_t(want.words, want.best_i, want.best_j,
                        max_steps=ms, W=Wd)
    tt = ts.traceback_static(got.words, got.best_i, got.best_j,
                             max_steps=ms)
    for a, b_, name in zip(tt, tw, ("moves", "n", "si", "sj")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_),
                                      err_msg=name)


def test_kernel_width_check():
    """The CUDA path takes W = max(band_width, 256) for every power-of-two
    band_width from 16 to 4096, so W a power of two from 256 to 4096, and
    raises for any other width."""
    assert ts.KERNEL_WIDTHS == (256, 512, 1024, 2048, 4096)
    for e in range(4, 13):
        ts._need_width(max(1 << e, 256))
    for Wd in (8, 48, 128, 8192, 3000):
        with pytest.raises(ValueError, match="power of two from 256 to 4096"):
            ts._need_width(Wd)
