"""The port's adaptive-band DP (aligngraph2_tpu_torch/ops/banded_dp.py)
against the JAX package's (aligngraph2_tpu/ops/banded_dp.py) on the same
numpy inputs: every output must be equal, exactly."""

import numpy as np
import pytest
import torch

from aligngraph2_tpu.io.seqdb import encode_seq, decode_seq
from aligngraph2_tpu.ops import banded_dp as jdp
from aligngraph2_tpu_torch.ops import banded_dp as tdp
from tests.synth import random_genome, mutate

torch.set_num_threads(1)

NQ, W = 128, 32


def _lanes(seed):
    """Planted lanes as the aligner builds them (window start
    max(0, diag - W)), plus edge cases: a seed diagonal before the window
    start, a query past its target, a short target, a random lane."""
    rng = np.random.default_rng(seed)
    NT = NQ + 2 * W
    q = np.zeros((6, NQ), np.uint8)
    t = np.zeros((6, NT), np.uint8)
    qlen = np.zeros(6, np.int32)
    tlen = np.zeros(6, np.int32)
    c0 = np.zeros(6, np.int32)
    g = encode_seq(random_genome(rng, 600))
    specs = [(150, 120, 0.15), (300, 100, 0.05), (10, 128, 0.02),
             (500, 90, 0.10), (60, 110, 0.30)]
    for b, (diag, ln, err) in enumerate(specs):
        read = encode_seq(mutate(rng, decode_seq(g[max(diag, 0):][:ln]),
                                 sub=err / 2, ins=err / 4, dele=err / 4))
        read = read[:NQ]
        q[b, :len(read)] = read
        qlen[b] = len(read)
        ws = max(0, diag - W)
        win = g[ws:ws + NT]
        t[b, :len(win)] = win
        tlen[b] = len(win)
        c0[b] = diag - ws
    c0[2] = -20            # seed diagonal before the window start
    q[5] = rng.integers(0, 4, NQ)
    qlen[5] = NQ
    t[5] = rng.integers(0, 4, NT)
    tlen[5] = NT
    return q, qlen, t, tlen, c0


@pytest.mark.parametrize("x_drop", [0, 250, 12])
def test_banded_align_and_traceback_equal_jax(x_drop):
    q, qlen, t, tlen, c0 = _lanes(5)
    want = jdp.banded_align(q, qlen, t, tlen, c0, W=W, x_drop=x_drop)
    got = tdp.banded_align(q, qlen, t, tlen, c0, W=W, x_drop=x_drop)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(np.asarray(want.score).min()) > 0
    ms = NQ + t.shape[1]
    mj = [np.asarray(x) for x in jdp.traceback(
        want.dirs, want.centers, want.best_i, want.best_j, max_steps=ms)]
    mt = [x.numpy() for x in tdp.traceback(
        got.dirs, got.centers, got.best_i, got.best_j, max_steps=ms)]
    for a, b, name in zip(mt, mj, ("moves", "n", "si", "sj")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # gapped strings, as the aligner rebuilds them from each lane's moves
    for b in range(len(q)):
        qb = int(mj[2][b])
        tb = int(mj[2][b] + np.asarray(want.centers)[b][mj[2][b]]
                 - W // 2 + mj[3][b])
        assert tdp.moves_to_strings(mt[0][b], q[b, :qlen[b]], qb, tb,
                                    t[b]) == \
            jdp.moves_to_strings(mj[0][b], q[b, :qlen[b]], qb, tb, t[b])


@pytest.mark.parametrize("stop_row", [70, 64, 65])
def test_every_lane_dead_between_checks_equal_jax(stop_row):
    """Every lane dies (its rows pass qlen) between two of the loop's
    every-64-row checks, or on one: the rows run after that, all lanes
    frozen, must leave what the JAX while_loop leaves when it stops at
    once, centers included."""
    q, qlen, t, tlen, c0 = _lanes(5)
    qlen = np.minimum(qlen, stop_row).astype(np.int32)
    want = jdp.banded_align(q, qlen, t, tlen, c0, W=W, x_drop=250)
    got = tdp.banded_align(q, qlen, t, tlen, c0, W=W, x_drop=250)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (np.asarray(want.centers)[:, stop_row + 1:] == 0).all()


def test_traceback_truncation_equal_jax():
    """max_steps cuts the walk short: moves, counts and the cursor where
    it stopped must match."""
    q, qlen, t, tlen, c0 = _lanes(9)
    res = tdp.banded_align(q, qlen, t, tlen, c0, W=W)
    for ms in (100, 17):
        mj = jdp.traceback(res.dirs.numpy(), res.centers.numpy(),
                           res.best_i.numpy(), res.best_j.numpy(),
                           max_steps=ms)
        mt = tdp.traceback(res.dirs, res.centers, res.best_i, res.best_j,
                           max_steps=ms)
        for a, b in zip(mt, mj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cuda_tensors_rejected():
    """The adaptive band runs on the device of its inputs, the CPU or a
    CUDA card; any other device raises instead of moving data."""
    q = torch.zeros((1, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        tdp.banded_align(q, [16], q, [16], [0], W=16)
