"""Static-band DP and traceback: the contract, its plain torch versions and
the wrappers of the CUDA kernels.

Counterpart of ``aligngraph2_tpu/ops/banded_pallas.py``.  Targets are
windows in the standard frame (seed diagonal at column W/2, cell (i, j)
reads t[i-1+j]); queries pad with Q_SENTINEL and targets with T_SENTINEL,
which never match, so padding never scores.

  * :func:`banded_dp_static` runs ``dp_static_kernel`` of
    ``csrc/banded_static.cu`` on CUDA tensors and
    :func:`banded_dp_static_ref` on CPU tensors.  It replaces
    ``banded_align_pallas`` / ``_dp_kernel``.
  * :func:`traceback_static` runs ``tb_static_kernel`` on CUDA tensors and
    :func:`traceback_static_ref` on CPU tensors.  It replaces
    ``traceback_t`` and ``traceback_packed_device``: moves come out dense,
    END->START, exactly as ``traceback_t`` writes them.

A wrapper given a CUDA tensor launches its kernel or raises; only a CPU
tensor takes the plain version.  Each wrapper counts its launches in
``<wrapper>.launches``.

Differences from the JAX module, on purpose:

  * ``words`` is laid out (B, NQ/16, W) instead of (NQ/16, W, B), so a
    lane's words are contiguous; :func:`unpack_words` inverts it.
  * x_drop is decided per lane every K rows (default 64): a lane stays
    alive iff row i+1 <= qlen and (best == 0 or max_j H >= best - x_drop),
    and a dead lane stops, leaving its later words unwritten.  The Pallas
    kernel decides per 128-lane tile, so there a dead lane keeps computing
    while a tile-mate lives and can recover.  The two agree exactly at
    x_drop = 0, and on every tile in which no lane recovers after its own
    death.  Rows at or above each lane's best_i, which are all the
    traceback reads, are written either way.
  * the results carry ``rows``, the rows each lane computed (DP cells =
    rows * W).
  * left out: the int16 row (``dt16``) and the ``probe_no_ks`` probe, the
    run-length traceback walk and its two-transfer fetch and host
    expansion (``traceback_packed_device``, ``expand_packed_moves``,
    ``_tb_meta``, ``_tb_body``, ``fetch_packed_traceback``,
    ``expand_moves``), and padding batches to a multiple of the tile:
    the kernels take any B and any NQ divisible by 16.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .banded_dp import (DIAG, LEFT, NEG, STOP, UP, _loop, ks_shifts,
                        maxplus_scan)

Q_SENTINEL = 254
T_SENTINEL = 255
# the band widths the CUDA kernels take: those the aligner forms,
# max(band_width, 256) for a power-of-two band_width from 16 to 4096 (one
# warp a lane up to 1024, W / 1024 warps a lane past it)
KERNEL_WIDTHS = tuple(1 << e for e in range(8, 13))


class StaticResult(NamedTuple):
    score: torch.Tensor    # (B,) int32
    best_i: torch.Tensor   # (B,) int32
    best_j: torch.Tensor   # (B,) int32
    words: torch.Tensor    # (B, NQ//16, W) int32 packed 2-bit directions;
                           # bits (2s, 2s+1) of word w = DP row 16*w + s + 1
    rows: torch.Tensor     # (B,) int32 rows computed


def banded_dp_static_ref(q, t, qlen=None, *, W, K=64, match=2, mismatch=-4,
                         gap=-3, x_drop=0) -> StaticResult:
    """Plain torch version of the static-band DP, row by row over the
    batch.  q: (B, NQ) uint8 padded with Q_SENTINEL; t: (B, NQ + W) uint8
    standard-frame windows padded with T_SENTINEL; qlen: (B,) int32
    (defaults to NQ).  Runs on whatever device its inputs are on; on a
    card the rows replay as CUDA graphs of 64 (``banded_dp._loop``)."""
    B, NQ = q.shape
    dev = q.device
    if qlen is None:
        qlen = torch.full((B,), NQ, dtype=torch.int32, device=dev)
    q32 = q.to(torch.int32)
    t32 = t.to(torch.int32)
    qlen = qlen.to(torch.int32)
    shifts = ks_shifts(W)
    words = torch.zeros((B, NQ // 16, W), dtype=torch.int32, device=dev)
    j_idx = torch.arange(W, dtype=torch.int64, device=dev)
    # 0-d tensors keep the row's values int32
    match_t, mismatch_t = (torch.tensor(x, dtype=torch.int32, device=dev)
                           for x in (match, mismatch))
    zero = torch.zeros((B, W), dtype=torch.int32, device=dev)
    S = dict(H=zero, bcol=zero.clone(), brow=zero.clone(),
             acc=zero.clone(),
             alive=torch.ones((B, 1), dtype=torch.bool, device=dev),
             rows=torch.full((B,), NQ, dtype=torch.int32, device=dev),
             i=torch.ones((), dtype=torch.int64, device=dev))   # next row

    def row(S):
        """DP row S["i"]: the next state; writes the row's direction bits
        into its word row (complete at every 16th row).  The row index is
        a tensor, so a CUDA graph can replay it."""
        i, H, alive = S["i"], S["H"], S["alive"]
        i1 = (i - 1).view(1)
        up = torch.nn.functional.pad(H[:, 1:], (0, 1), value=NEG)
        sub = torch.where(t32.index_select(1, j_idx + (i - 1))
                          == q32.index_select(1, i1), match_t, mismatch_t)
        d_v = H + sub
        u_v = up + gap
        M = torch.maximum(d_v, u_v)
        m_dir = torch.where(d_v >= u_v, DIAG, UP)
        m_dir = torch.where(M > 0, m_dir, STOP)
        M = M.clamp(min=0)
        Hn = maxplus_scan(M, gap, shifts)
        code = torch.where(Hn > M, LEFT, m_dir).to(torch.int32)
        upd = Hn > S["bcol"]
        if x_drop > 0:
            Hn = torch.where(alive, Hn, H)
            upd = upd & alive
        acc = S["acc"] | (code << (2 * ((i - 1) % 16)).to(torch.int32))
        word = torch.where(alive, acc, 0) if x_drop > 0 else acc
        words.index_copy_(1, i1 // 16, word[:, None])
        nxt = dict(S, H=Hn, i=i + 1,
                   bcol=torch.where(upd, Hn, S["bcol"]),
                   brow=torch.where(upd, i.to(torch.int32), S["brow"]),
                   acc=torch.where(i % 16 == 0, 0, acc))
        if x_drop > 0:
            # every K rows, before the last: a lane lives iff row i+1 <=
            # qlen and (best == 0 or its front is within x_drop of best)
            front = Hn.amax(dim=1, keepdim=True)
            best = nxt["bcol"].amax(dim=1, keepdim=True)
            ok = (i + 1 <= qlen[:, None]) \
                & ((best == 0) | (front >= best - x_drop))
            died = alive & ~ok & ((i % K == 0) & (i < NQ))
            nxt["rows"] = torch.where(died[:, 0], i.to(torch.int32),
                                      S["rows"])
            nxt["alive"] = alive & ~died
        return nxt

    # a lane that died is frozen, so rows run after every lane died change
    # nothing; asking every 64 rows gives the early stop's result
    _loop(row, S, NQ, lambda S: x_drop > 0 and not bool(S["alive"].any()))
    bcol, brow = S["bcol"], S["brow"]
    score = bcol.amax(dim=1)
    mask = bcol == score[:, None]
    istar = torch.where(mask, brow, 1 << 30).amin(dim=1)
    jstar = torch.where(mask & (brow == istar[:, None]),
                        j_idx[None, :].to(torch.int32), W).amin(dim=1)
    istar = torch.where(score > 0, istar, 0).to(torch.int32)
    jstar = torch.where(score > 0, jstar, 0).to(torch.int32)
    return StaticResult(score, istar, jstar, words, S["rows"])


def traceback_static_ref(words, best_i, best_j, *, max_steps):
    """Plain torch version of the traceback over the packed words.

    Returns (moves (B, max_steps) uint8 END->START, n_moves, start_i,
    start_j), as ``traceback_t``; the alignment's target start in the
    window is start_i + start_j.  Stops early once every lane has stopped
    (checked every 64 steps); on a card the steps replay as CUDA graphs
    of 64."""
    B, NW, W = words.shape
    dev = words.device
    lanes = torch.arange(B, device=dev)
    moves = torch.zeros((B, max_steps), dtype=torch.uint8, device=dev)

    def walk(S):
        """One move of every lane, written at column S["step"]."""
        i, j, active = S["i"], S["j"], S["active"]
        ii = (i - 1).clamp(min=0)
        word = words[lanes, (ii >> 4).clamp(0, NW - 1).long(),
                     j.clamp(0, W - 1).long()]
        cur = (word >> (2 * (ii & 15))) & 3
        cur = torch.where(active & (i > 0), cur, STOP)
        ni = torch.where(cur == LEFT, i, i - 1)
        nj = torch.where(cur == LEFT, j - 1,
                         torch.where(cur == DIAG, j, j + 1))
        live = active & (cur != STOP)
        moves.index_copy_(1, S["step"].long().view(1),
                          cur.to(torch.uint8)[:, None])
        return dict(i=torch.where(live, ni, i), j=torch.where(live, nj, j),
                    active=live, step=S["step"] + 1)

    S = dict(i=best_i.to(torch.int32).clone(),
             j=best_j.to(torch.int32).clone(),
             active=torch.ones(B, dtype=torch.bool, device=dev),
             step=torch.zeros((), dtype=torch.int32, device=dev))
    _loop(walk, S, max_steps, lambda S: not bool(S["active"].any()))
    n = (moves != 0).sum(dim=1, dtype=torch.int32)
    return moves, n, S["i"], S["j"]


def _need_width(W: int) -> None:
    """Raise unless the kernels take band width ``W``: a power of two
    from 256 to 4096."""
    if W not in KERNEL_WIDTHS:
        raise ValueError(f"W={W}: the static-band kernels take W a power "
                         f"of two from {KERNEL_WIDTHS[0]} to "
                         f"{KERNEL_WIDTHS[-1]}")


def banded_dp_static(q, t, qlen=None, *, W, K=64, match=2, mismatch=-4,
                     gap=-3, x_drop=0) -> StaticResult:
    """Static-band DP: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors (same arguments as :func:`banded_dp_static_ref`).
    The kernel takes W in :data:`KERNEL_WIDTHS`."""
    if q.device.type == "cpu":
        return banded_dp_static_ref(q, t, qlen, W=W, K=K, match=match,
                                    mismatch=mismatch, gap=gap,
                                    x_drop=x_drop)
    from . import _cuda
    B, NQ = q.shape
    if qlen is None:
        qlen = torch.full((B,), NQ, dtype=torch.int32, device=q.device)
    _cuda.need(q, "q", torch.uint8, (B, NQ))
    _cuda.need(t, "t", torch.uint8, (B, NQ + W))
    _cuda.need(qlen, "qlen", torch.int32, (B,))
    _need_width(W)
    if NQ % 16 or K % 16 or K <= 0 or NQ >= 1 << 20 or x_drop < 0:
        raise ValueError(f"NQ={NQ}, K={K}, x_drop={x_drop}: need NQ and K "
                         f"multiples of 16, NQ < 2^20, x_drop >= 0")
    lib = _cuda.get_lib()
    dev = q.device
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)]
    words = torch.empty((B, NQ // 16, W), dtype=torch.int32, device=dev)
    index, stream = _cuda.launch_target(dev)
    code = lib.agc_dp_static(
        index, q.data_ptr(), t.data_ptr(), qlen.data_ptr(), B, NQ, W, K,
        match, mismatch, gap, x_drop, *(o.data_ptr() for o in out),
        words.data_ptr(), stream)
    _cuda.check(lib, code, "dp_static_kernel launch")
    banded_dp_static.launches += 1
    score, best_i, best_j, rows = out
    return StaticResult(score, best_i, best_j, words, rows)


banded_dp_static.launches = 0


def traceback_static(words, best_i, best_j, *, max_steps):
    """Traceback over packed words: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (see :func:`traceback_static_ref`)."""
    if words.device.type == "cpu":
        return traceback_static_ref(words, best_i, best_j,
                                    max_steps=max_steps)
    from . import _cuda
    B, NW, W = words.shape
    _cuda.need(words, "words", torch.int32, (B, NW, W))
    _cuda.need(best_i, "best_i", torch.int32, (B,))
    _cuda.need(best_j, "best_j", torch.int32, (B,))
    _need_width(W)
    if max_steps <= 0:
        raise ValueError(f"max_steps={max_steps} must be positive")
    lib = _cuda.get_lib()
    dev = words.device
    # the kernel stores moves as aligned 32-bit words: pad each row to 16
    stride = -(-max_steps // 16) * 16
    moves = torch.zeros((B, stride), dtype=torch.uint8, device=dev)
    n, si, sj = (torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in range(3))
    index, stream = _cuda.launch_target(dev)
    code = lib.agc_tb_static(
        index, words.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), B,
        NW, W, max_steps, stride, moves.data_ptr(), n.data_ptr(),
        si.data_ptr(), sj.data_ptr(), stream)
    _cuda.check(lib, code, "tb_static_kernel launch")
    traceback_static.launches += 1
    return moves[:, :max_steps], n, si, sj


traceback_static.launches = 0


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(B, NQ//16, W) int32 packed words -> (B, NQ, W) uint8 direction
    codes (inverse of the in-register packing; test aid)."""
    B, NW, W = words.shape
    shifts = (torch.arange(16, dtype=torch.int32, device=words.device)
              * 2)[None, None, :, None]
    d = (words[:, :, None, :] >> shifts) & 3
    return d.to(torch.uint8).reshape(B, NW * 16, W)


def standard_frame_windows(t_codes_list, diags, NQ, W):
    """Host helper: build (B, NQ + W) sentinel-padded target windows with
    each candidate's seed diagonal centered (window start = diag - W/2)."""
    B = len(t_codes_list)
    out = np.full((B, NQ + W), T_SENTINEL, np.uint8)
    starts = np.zeros(B, np.int64)
    for b, (codes, diag) in enumerate(zip(t_codes_list, diags)):
        ws = diag - W // 2
        starts[b] = ws
        lo = max(0, ws)
        hi = min(len(codes), ws + NQ + W)
        if hi > lo:
            out[b, lo - ws:hi - ws] = codes[lo:hi]
    return out, starts
