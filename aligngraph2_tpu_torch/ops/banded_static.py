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

from .banded_dp import DIAG, LEFT, NEG, STOP, UP, ks_shifts, maxplus_scan

Q_SENTINEL = 254
T_SENTINEL = 255
# the band widths the CUDA kernels take: those the aligner forms,
# max(band_width, 256) for a power-of-two band_width up to 1024
KERNEL_WIDTHS = (256, 512, 1024)


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
    (defaults to NQ).  Runs on whatever device its inputs are on."""
    B, NQ = q.shape
    dev = q.device
    if qlen is None:
        qlen = torch.full((B,), NQ, dtype=torch.int32, device=dev)
    q32 = q.to(torch.int32)
    t32 = t.to(torch.int32)
    qlen = qlen.to(torch.int32)
    shifts = ks_shifts(W)
    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    bcol = torch.zeros_like(H)
    brow = torch.zeros_like(H)
    acc = torch.zeros_like(H)
    words = torch.zeros((B, NQ // 16, W), dtype=torch.int32, device=dev)
    rows = torch.full((B,), NQ, dtype=torch.int32, device=dev)
    alive = torch.ones((B, 1), dtype=torch.bool, device=dev)
    for i in range(1, NQ + 1):
        up = torch.nn.functional.pad(H[:, 1:], (0, 1), value=NEG)
        sub = torch.where(t32[:, i - 1:i - 1 + W] == q32[:, i - 1:i],
                          match, mismatch)
        d_v = H + sub
        u_v = up + gap
        M = torch.maximum(d_v, u_v)
        m_dir = torch.where(d_v >= u_v, DIAG, UP)
        m_dir = torch.where(M > 0, m_dir, STOP)
        M = M.clamp(min=0)
        Hn = maxplus_scan(M, gap, shifts)
        code = torch.where(Hn > M, LEFT, m_dir).to(torch.int32)
        upd = Hn > bcol
        if x_drop > 0:
            Hn = torch.where(alive, Hn, H)
            upd = upd & alive
        bcol = torch.where(upd, Hn, bcol)
        brow = torch.where(upd, i, brow).to(torch.int32)
        acc = acc | (code << (2 * ((i - 1) % 16)))
        if i % 16 == 0:
            if x_drop > 0:
                acc = torch.where(alive, acc, 0).to(torch.int32)
            words[:, (i - 1) // 16] = acc
            acc = torch.zeros_like(acc)
        H = Hn
        if x_drop > 0 and i % K == 0 and i < NQ:
            front = H.amax(dim=1, keepdim=True)
            best = bcol.amax(dim=1, keepdim=True)
            ok = (i + 1 <= qlen[:, None]) \
                & ((best == 0) | (front >= best - x_drop))
            died = alive & ~ok
            rows = torch.where(died[:, 0], i, rows).to(torch.int32)
            alive = alive & ok
            if not bool(alive.any()):
                break
    S = bcol.amax(dim=1)
    mask = bcol == S[:, None]
    istar = torch.where(mask, brow, 1 << 30).amin(dim=1)
    j_idx = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    jstar = torch.where(mask & (brow == istar[:, None]), j_idx, W).amin(dim=1)
    istar = torch.where(S > 0, istar, 0).to(torch.int32)
    jstar = torch.where(S > 0, jstar, 0).to(torch.int32)
    return StaticResult(S, istar, jstar, words, rows)


def traceback_static_ref(words, best_i, best_j, *, max_steps):
    """Plain torch version of the traceback over the packed words.

    Returns (moves (B, max_steps) uint8 END->START, n_moves, start_i,
    start_j), as ``traceback_t``; the alignment's target start in the
    window is start_i + start_j.  Stops early once every lane has stopped
    (checked every 64 steps)."""
    B, NW, W = words.shape
    dev = words.device
    lanes = torch.arange(B, device=dev)
    i = best_i.to(torch.int32).clone()
    j = best_j.to(torch.int32).clone()
    active = torch.ones(B, dtype=torch.bool, device=dev)
    moves = torch.zeros((B, max_steps), dtype=torch.uint8, device=dev)
    for step in range(max_steps):
        ii = (i - 1).clamp(min=0)
        word = words[lanes, (ii >> 4).clamp(0, NW - 1).long(),
                     j.clamp(0, W - 1).long()]
        cur = (word >> (2 * (ii & 15))) & 3
        cur = torch.where(active & (i > 0), cur, STOP)
        ni = torch.where(cur == LEFT, i, i - 1)
        nj = torch.where(cur == LEFT, j - 1,
                         torch.where(cur == DIAG, j, j + 1))
        live = active & (cur != STOP)
        i = torch.where(live, ni, i)
        j = torch.where(live, nj, j)
        active = live
        moves[:, step] = cur.to(torch.uint8)
        if step % 64 == 63 and not bool(active.any()):
            break
    n = (moves != 0).sum(dim=1, dtype=torch.int32)
    return moves, n, i, j


def _need(x: torch.Tensor, name: str, dtype, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _need_width(W: int) -> None:
    if W not in KERNEL_WIDTHS:
        raise ValueError(f"W={W}: the kernels take W in {KERNEL_WIDTHS}")


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
    _need(q, "q", torch.uint8, (B, NQ))
    _need(t, "t", torch.uint8, (B, NQ + W))
    _need(qlen, "qlen", torch.int32, (B,))
    _need_width(W)
    if NQ % 16 or K % 16 or K <= 0 or NQ >= 1 << 20 or x_drop < 0:
        raise ValueError(f"NQ={NQ}, K={K}, x_drop={x_drop}: need NQ and K "
                         f"multiples of 16, NQ < 2^20, x_drop >= 0")
    lib = _cuda.get_lib()
    dev = q.device
    out = [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4)]
    words = torch.empty((B, NQ // 16, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.agc_dp_static(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        q.data_ptr(), t.data_ptr(), qlen.data_ptr(), B, NQ, W, K, match,
        mismatch, gap, x_drop, *(o.data_ptr() for o in out),
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
    _need(words, "words", torch.int32, (B, NW, W))
    _need(best_i, "best_i", torch.int32, (B,))
    _need(best_j, "best_j", torch.int32, (B,))
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.agc_tb_static(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        words.data_ptr(), best_i.data_ptr(), best_j.data_ptr(), B, NW, W,
        max_steps, stride, moves.data_ptr(), n.data_ptr(), si.data_ptr(),
        sj.data_ptr(), stream)
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
