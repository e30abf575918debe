"""Adaptive banded local-alignment DP and its traceback: the plain torch
versions and the wrappers of the CUDA kernels.

Counterpart of ``aligngraph2_tpu/ops/banded_dp.py``, which XLA compiles
into one device loop per scan.  Same semantics, value for value:

  * Smith-Waterman local alignment with linear gaps, int32 scores;
  * an adaptive band of W cells whose centre drifts by at most +-1 per row
    toward the argmax of the previous row;
  * the in-row gap chain as a Kogge-Stone max-plus scan over the same
    ``log2(W)`` shifts;
  * ``x_drop == 0``: every lane runs all NQ rows (the JAX ``vmap``/``scan``
    form, whose band centre is clipped to the padded target length);
    ``x_drop > 0``: each lane freezes on its own once its frontier falls
    more than x_drop below its best or its rows pass qlen, and the loop
    stops when every lane is frozen (the JAX ``while_loop`` form, whose
    centre is clipped to the window length NT).

The JAX functions vectorise one lane with ``vmap``; here the batch is the
leading dimension of every tensor and rows are a Python loop.  Out-of-range
reads reproduce JAX's gather rules (a target read before the window is a
sentinel; a traceback index wraps when negative, then clamps).

  * :func:`banded_align` runs ``dp_adaptive_kernel`` of
    ``csrc/banded_adaptive.cu`` on CUDA tensors and
    :func:`banded_align_ref` on CPU tensors (numpy inputs go to the CPU).
  * :func:`traceback` runs ``tb_adaptive_kernel`` on CUDA tensors and
    :func:`traceback_ref` on CPU tensors.
  * :func:`gapped_strings` runs ``tb_strings_kernel``, which makes the
    walks' gapped strings on the card, where :func:`moves_to_strings`
    makes them on the host (the mesh path's extender takes it on a card,
    ``parallel/sharded.py``); :func:`decode_strings` reads a lane's row.

A wrapper given a CUDA tensor launches its kernel or raises; only a CPU
tensor takes the plain version.  Each wrapper counts its launches in
``<wrapper>.launches``.  The kernels take W in :data:`KERNEL_WIDTHS`.

The plain versions run on the device of their inputs, the CPU or a CUDA
card: torch ops stand in for XLA's.  Each DP row and each traceback move
is a few dozen small ops, so on a card both loops replay a CUDA graph of
64 rows or moves at a time (``_loop``), and ask whether a lane is still
alive only between graphs; the card runs them only to hold the kernels
against them.

The band runs on every lane of the mesh path's extender
(``parallel/sharded.py``), on the aligner's CPU path, and on the
single-device card path for the reads past the 65536 bucket.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -(1 << 28)
# the band widths the CUDA kernels take: every power of two from 16 to
# 4096 (one warp a lane up to 1024, W / 1024 warps a lane past it)
KERNEL_WIDTHS = tuple(1 << e for e in range(4, 13))

# direction codes
STOP, DIAG, UP, LEFT = 0, 1, 2, 3


class BandedResult(NamedTuple):
    score: torch.Tensor     # (B,) int32 best local score
    best_i: torch.Tensor    # (B,) int32 query end row (exclusive)
    best_j: torch.Tensor    # (B,) int32 band column of the end cell
    dirs: torch.Tensor      # (B, NQ, W) uint8 direction codes per cell
    centers: torch.Tensor   # (B, NQ+1) int32 band center diagonal per row


def _i32(x, device=None) -> torch.Tensor:
    """x as an int32 tensor on ``device`` (default: where x is; numpy on
    the CPU).  Raises for a device other than the CPU or a CUDA card."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    dev = t.device if device is None else torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the adaptive band runs on cpu or cuda tensors, "
                         f"got {dev}")
    return t.to(device=dev, dtype=torch.int32)


def ks_shifts(W: int):
    """The scan shifts of the JAX package: 1, 2, ..., 2^(floor(log2 W)-1)."""
    return tuple(1 << s for s in range(int(np.log2(W))))


def maxplus_scan(M: torch.Tensor, gap: int, shifts) -> torch.Tensor:
    """Kogge-Stone max-plus prefix along the last dimension:
    H[j] = max(H[j], H[j - sh] + gap * sh) for each shift, NEG shifted in."""
    H = M
    for sh in shifts:
        shifted = torch.nn.functional.pad(H[..., :-sh], (sh, 0), value=NEG)
        H = torch.maximum(H, shifted + gap * sh)
    return H


def banded_align_ref(q, qlen, t, tlen, c0, *, W=256, match=2, mismatch=-4,
                     gap=-3, x_drop=0) -> BandedResult:
    """Batched adaptive banded local alignment: the plain version.

    q: (B, NQ) uint8 query codes (aligned strand), qlen: (B,)
    t: (B, NT) uint8 target window codes,           tlen: (B,)
    c0: (B,) initial band center diagonal (t_pos - q_pos estimate,
        relative to the window start)
    x_drop: > 0 enables per-lane early termination (see module docstring).
    """
    q = _i32(q)
    dev = q.device
    t = _i32(t, dev)
    qlen, tlen, c0 = _i32(qlen, dev), _i32(tlen, dev), _i32(c0, dev)
    B, NQ = q.shape
    NT = t.shape[1]
    PADL = W + 2
    # t_pad as in the JAX package, plus W more sentinels on the left so a
    # read before the window (which JAX answers with a sentinel) indexes
    # in bounds
    t_pad = torch.cat([torch.full((B, W + PADL), 255, dtype=torch.int32,
                                  device=dev), t,
                       torch.full((B, W + NQ + 2), 255, dtype=torch.int32,
                                  device=dev)], dim=1)
    L = NT + 2 * W + NQ + 4          # the JAX t_pad length
    xd = x_drop > 0
    c_hi = NT if xd else L
    shifts = ks_shifts(W)
    j_idx = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    p0 = c0[:, None] - W // 2 + j_idx
    dirs = torch.zeros((B, NQ, W), dtype=torch.uint8, device=dev)
    centers = torch.zeros((B, NQ + 1), dtype=torch.int32, device=dev)
    centers[:, 0] = c0
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    S = dict(H=torch.where((p0 >= 0) & (p0 <= tlen[:, None]), 0, NEG
                           ).to(torch.int32),
             c=c0.clone(), best=zeros, b_i=zeros.clone(), b_j=zeros.clone(),
             alive=torch.ones(B, dtype=torch.bool, device=dev),
             # the last row each lane started alive: rows after the last
             # of them froze every lane, and their centers are undone
             # after the loop
             last=zeros.clone(),
             i=torch.ones((), dtype=torch.int32, device=dev))   # next row
    # gather columns: diag and up of padded H (diag = du[:, :W], up =
    # du[:, 1:]), and the target window's W cells
    du_idx = torch.arange(1, W + 2, device=dev)[None, :]
    t_idx = j_idx.long() + W
    # 0-d tensors keep the row's values int32 and its codes uint8
    match_t, mismatch_t = (torch.tensor(x, dtype=torch.int32, device=dev)
                           for x in (match, mismatch))
    diag8, up8 = (torch.tensor(x, dtype=torch.uint8, device=dev)
                  for x in (DIAG, UP))

    def row(S):
        """DP row S["i"]: the next state; writes the row's dirs and
        center.  The row index is a tensor, so a CUDA graph can replay
        it."""
        i, H, c, alive = S["i"], S["H"], S["c"], S["alive"]
        i1 = (i - 1).long().view(1)
        # torch.max, like jnp.argmax, returns the first maximum
        row_max, arg = H.max(dim=1)
        drift = arg.to(torch.int32) - W // 2
        dc = torch.where(row_max > 0, drift.clamp(-1, 1), 0)
        c_new = (c + dc).clamp(-W, c_hi)
        padded = torch.nn.functional.pad(H, (1, 2), value=NEG)
        du = padded.gather(1, dc[:, None] + du_idx)
        start = c_new + (i + (PADL - W // 2 - 1))
        if not xd:
            # dynamic_slice clamps the start into [0, L - W]
            start = start.clamp(0, L - W)
        t_slice = t_pad.gather(1, start[:, None] + t_idx)
        q_col = q.gather(1, i1.expand(B, 1))
        sub = torch.where(t_slice == q_col, match_t, mismatch_t)
        d_v = du[:, :W] + sub
        u_v = du[:, 1:] + gap
        M = torch.maximum(d_v, u_v)
        m_dir = torch.where(d_v >= u_v, diag8, up8)
        m_dir = torch.where(M > 0, m_dir, STOP)
        M = M.clamp(min=0)
        Hn = maxplus_scan(M, gap, shifts)
        row_dirs = torch.where(Hn > M, LEFT, m_dir)
        p = c_new[:, None] + (j_idx + (i - W // 2))
        ok = (p >= 0) & (p <= tlen[:, None]) & (i <= qlen[:, None])
        Hn = torch.where(ok, Hn, NEG)
        row_dirs = torch.where(ok, row_dirs, STOP)
        if xd:
            # dead lanes freeze: state unchanged, dirs stay STOP
            Hn = torch.where(alive[:, None], Hn, H)
            c_new = torch.where(alive, c_new, c)
            row_dirs = torch.where(alive[:, None], row_dirs, STOP)
        r_max, r_arg = Hn.max(dim=1)
        upd = r_max > S["best"]
        if xd:
            upd = upd & alive
        dirs.index_copy_(1, i1, row_dirs[:, None])
        centers.index_copy_(1, i1 + 1, c_new[:, None])
        nxt = dict(S, H=Hn, c=c_new, i=i + 1,
                   best=torch.where(upd, r_max, S["best"]),
                   b_i=torch.where(upd, i, S["b_i"]),
                   b_j=torch.where(upd, r_arg.to(torch.int32), S["b_j"]))
        if xd:
            nxt["last"] = torch.where(alive, i, S["last"])
            nxt["alive"] = alive & (i < qlen) \
                & ((nxt["best"] == 0) | (r_max >= nxt["best"] - x_drop))
        return nxt

    # the JAX while_loop stops once no lane is alive; asking every 64 rows
    # gives the same result, since a dead lane is frozen
    _loop(row, S, NQ, lambda S: xd and not bool(S["alive"].any()))
    if xd:
        centers[:, int(S["last"].max()) + 1:] = 0
    return BandedResult(S["best"], S["b_i"], S["b_j"], dirs, centers)


CHUNK = 64


def _loop(step, S, n, stop) -> None:
    """S = step(S), n times, stopping early where stop(S) says so, asked
    before every CHUNK steps.  S's tensors are updated in place, a chunk
    of steps at a time.  On a card each step is a few dozen small ops, so
    after one chunk run eagerly (which readies every op) a chunk is
    captured once as a CUDA graph and replayed: one launch for CHUNK
    steps instead of thousands."""

    def steps(m):
        T = S
        for _ in range(m):
            T = step(T)
        for k, v in S.items():
            v.copy_(T[k])

    on_card = next(iter(S.values())).is_cuda
    graph = None
    done = 0
    while done < n:
        if done % CHUNK == 0 and stop(S):
            break
        m = min(CHUNK, n - done)
        if on_card and m == CHUNK and done:
            if graph is None:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    steps(CHUNK)
            graph.replay()
        else:
            steps(m)
        done += m


def _jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's rule for a gather index: wrap once if negative, then clamp."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()


def traceback_ref(dirs, centers, best_i, best_j, *, max_steps):
    """Batched traceback of :func:`banded_align`: the plain version.

    Returns (moves (B, max_steps) uint8 in END->START order, n_moves (B,),
    start_i (B,), start_j (B,)).  Move codes are DIAG/UP/LEFT; 0 entries
    past n_moves are padding.  The loop ends early once every lane has
    stopped (checked every 64 steps); later steps would only write
    padding.
    """
    B, NQ, W = dirs.shape
    dev = dirs.device
    lanes = torch.arange(B, device=dev)
    moves = torch.zeros((B, max_steps), dtype=torch.uint8, device=dev)

    def walk(S):
        """One move of every lane, written at column S["step"]."""
        i, j, active = S["i"], S["j"], S["active"]
        ii = (i - 1).clamp(min=0)
        iil = ii.long()   # >= 0: JAX's rule is only its upper clamp
        cur = dirs[lanes, iil.clamp(max=NQ - 1), _jax_index(j, W)
                   ].to(torch.int32)
        cur = torch.where(active & (i > 0), cur, STOP)
        dc = centers[lanes, _jax_index(i, NQ + 1)] \
            - centers[lanes, iil.clamp(max=NQ)]
        ni = torch.where(cur == LEFT, i, i - 1)
        nj = torch.where(cur == LEFT, j - 1,
                         torch.where(cur == DIAG, j + dc, j + dc + 1))
        live = active & (cur != STOP)
        moves.index_copy_(1, S["step"].long().view(1),
                          cur.to(torch.uint8)[:, None])
        return dict(i=torch.where(live, ni, i), j=torch.where(live, nj, j),
                    active=live, step=S["step"] + 1)

    S = dict(i=_i32(best_i, dev).clone(), j=_i32(best_j, dev).clone(),
             active=torch.ones(B, dtype=torch.bool, device=dev),
             step=torch.zeros((), dtype=torch.int32, device=dev))
    _loop(walk, S, max_steps, lambda S: not bool(S["active"].any()))
    i, j = S["i"], S["j"]
    n = (moves != 0).sum(dim=1, dtype=torch.int32)
    return moves, n, i, j


# ---------------------------------------------------------------------------
# the CUDA kernels


def key_bits(W: int) -> int:
    """The column bits of dp_adaptive_kernel's row key at band width W
    (key_bits of the kernel): 10 up to W = 1024, log2 W past it."""
    return max(10, (W - 1).bit_length())


def packed_key_ok(match: int, NQ: int, W: int) -> bool:
    """Whether dp_adaptive_kernel may reduce a row with one packed key,
    h << key_bits(W) | (2^key_bits(W) - 1 - column): every score of NQ
    rows is at most max(match, 0) * NQ, so every key fits int32 iff that
    bound is below 2^(31 - key_bits(W)).  Otherwise the kernel takes two
    reductions a row (the maximum, then its first column).  A choice by
    shape."""
    return max(match, 0) * NQ < 1 << (31 - key_bits(W))


def need_width(W: int) -> None:
    """Raise unless the kernels take band width ``W``: a power of two
    from 16 to 4096."""
    if W not in KERNEL_WIDTHS:
        raise ValueError(f"W={W}: the adaptive-band kernels take W a power "
                         f"of two from {KERNEL_WIDTHS[0]} to "
                         f"{KERNEL_WIDTHS[-1]}")


def banded_align(q, qlen, t, tlen, c0, *, W=256, match=2, mismatch=-4,
                 gap=-3, x_drop=0) -> BandedResult:
    """Adaptive banded local alignment: the CUDA kernel when ``q`` is a
    CUDA tensor, else the plain version (same arguments as
    :func:`banded_align_ref`).  On the card q and t are uint8, qlen, tlen
    and c0 int32, all on q's device, and NT a multiple of 16."""
    if not (torch.is_tensor(q) and q.is_cuda):
        return banded_align_ref(q, qlen, t, tlen, c0, W=W, match=match,
                                mismatch=mismatch, gap=gap, x_drop=x_drop)
    return dp_adaptive(q, qlen, t, tlen, c0, W=W, match=match,
                       mismatch=mismatch, gap=gap, x_drop=x_drop)[0]


banded_align.launches = 0


def dp_adaptive(q, qlen, t, tlen, c0, *, W, match, mismatch, gap, x_drop):
    """Launch ``dp_adaptive_kernel`` on CUDA tensors: (BandedResult, rows
    each lane ran).  Raises on any input the kernel does not take."""
    from . import _cuda
    B, NQ = q.shape
    NT = t.shape[1]
    dev = q.device
    _cuda.need(q, "q", torch.uint8, (B, NQ))
    _cuda.need(t, "t", torch.uint8, (B, NT), dev)
    for x, name in ((qlen, "qlen"), (tlen, "tlen"), (c0, "c0")):
        _cuda.need(x, name, torch.int32, (B,), dev)
    need_width(W)
    if NQ < 1 or NT % 16 or t.data_ptr() % 16 or x_drop < 0:
        raise ValueError(f"NQ={NQ}, NT={NT}, x_drop={x_drop}: need NQ >= 1, "
                         "NT a multiple of 16, t 16-byte aligned, "
                         "x_drop >= 0")
    lib = _cuda.get_adaptive_lib()
    score, best_i, best_j, rows, c_last = (
        torch.empty(B, dtype=torch.int32, device=dev) for _ in range(5))
    dirs = torch.zeros((B, NQ, W), dtype=torch.uint8, device=dev)
    centers = torch.empty((B, NQ + 1), dtype=torch.int32, device=dev)
    c_hi = NT if x_drop > 0 else NT + 2 * W + NQ + 4
    index, stream = _cuda.launch_target(dev)
    code = lib.agc_dp_adaptive(
        index, q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
        c0.data_ptr(), B, NQ, NT, W, c_hi, match, mismatch, gap, x_drop,
        int(packed_key_ok(match, NQ, W)), score.data_ptr(),
        best_i.data_ptr(),
        best_j.data_ptr(), dirs.data_ptr(), centers.data_ptr(),
        rows.data_ptr(), c_last.data_ptr(), stream)
    _cuda.check(lib, code, "dp_adaptive_kernel launch")
    banded_align.launches += 1
    centers = fill_centers(centers, rows, c_last, x_drop)
    return BandedResult(score, best_i, best_j, dirs, centers), rows


def fill_centers(centers, rows, c_last, x_drop) -> torch.Tensor:
    """The centres of the rows after each lane's last, as the JAX loops
    leave them: ``c_last`` (the lane's frozen centre) up to the batch's last
    row run, 0 after it at ``x_drop > 0``; ``c_last`` to the end at
    ``x_drop == 0``, where the centre no longer moves past qlen + 1.  Rows
    up to ``rows`` are kept.  Torch ops on the tensors' device, with no
    sync."""
    idx = torch.arange(centers.shape[1], device=centers.device)[None, :]
    keep = torch.where(idx <= rows.max(), c_last[:, None], 0) if x_drop > 0 \
        else c_last[:, None]
    return torch.where(idx > rows[:, None], keep, centers)


def traceback(dirs, centers, best_i, best_j, *, max_steps):
    """Traceback of :func:`banded_align`: the CUDA kernel when ``dirs`` is
    a CUDA tensor, else the plain version (see :func:`traceback_ref`).  On
    the card dirs is uint8, centers, best_i and best_j int32."""
    if not dirs.is_cuda:
        return traceback_ref(dirs, centers, best_i, best_j,
                             max_steps=max_steps)
    from . import _cuda
    B, NQ, W = dirs.shape
    dev = dirs.device
    _cuda.need(dirs, "dirs", torch.uint8, (B, NQ, W))
    _cuda.need(centers, "centers", torch.int32, (B, NQ + 1), dev)
    _cuda.need(best_i, "best_i", torch.int32, (B,), dev)
    _cuda.need(best_j, "best_j", torch.int32, (B,), dev)
    need_width(W)
    if max_steps <= 0 or NQ < 1 or dirs.data_ptr() % 16:
        raise ValueError(f"max_steps={max_steps}, NQ={NQ}: need both "
                         "positive and dirs 16-byte aligned")
    lib = _cuda.get_adaptive_lib()
    # the kernel stores moves as aligned 32-bit words: pad each row to 16
    stride = -(-max_steps // 16) * 16
    moves = torch.zeros((B, stride), dtype=torch.uint8, device=dev)
    n, si, sj = (torch.empty(B, dtype=torch.int32, device=dev)
                 for _ in range(3))
    index, stream = _cuda.launch_target(dev)
    code = lib.agc_tb_adaptive(
        index, dirs.data_ptr(), centers.data_ptr(), best_i.data_ptr(),
        best_j.data_ptr(), B, NQ, W, max_steps, stride, moves.data_ptr(),
        n.data_ptr(), si.data_ptr(), sj.data_ptr(), stream)
    _cuda.check(lib, code, "tb_adaptive_kernel launch")
    traceback.launches += 1
    return moves[:, :max_steps], n, si, sj


traceback.launches = 0


def start_column(centers, si, sj, W):
    """The window column where each walk starts, from its start row and
    band column (:func:`traceback`'s si, sj): si + centers[si] - W/2 +
    sj, on the tensors' device."""
    cen = centers.gather(
        1, _jax_index(si, centers.shape[1])[:, None]).squeeze(1)
    return si + cen - W // 2 + sj

# a row of gapped_strings: a header of STRINGS_HEAD bytes, int32 words
# (score, start row si, start window column tb, qe, te, move count n, 0, 0),
# then the query's gapped ASCII string and the target's, each in a field of
# strings_stride(max_steps) bytes, zero past n.  n is -1 where
# moves_to_strings raises (an index out of range).
STRINGS_HEAD = 32


def strings_stride(max_steps: int) -> int:
    """Bytes of each string's field in a gapped_strings row."""
    return -(-max_steps // 16) * 16


def gapped_strings(moves, n, si, tb, score, q, qlen, t, tlen):
    """Launch ``tb_strings_kernel`` on CUDA tensors: each lane's gapped
    strings of :func:`traceback`'s walk, as :func:`moves_to_strings` makes
    them on the host, in rows of ``STRINGS_HEAD + 2 *
    strings_stride(max_steps)`` bytes (the layout above).  ``moves`` (B,
    max_steps) uint8 and ``n``, ``si`` are :func:`traceback`'s (moves may
    be its view of padded rows), ``tb`` the start window column, ``score``
    the lane's score (copied into the header), q (B, NQ) and t (B, NT)
    uint8 and qlen, tlen int32 the DP's inputs.  No sync.  Raises on any
    input the kernel does not take; the CPU's route is
    :func:`moves_to_strings`."""
    from . import _cuda
    B, max_steps = moves.shape
    NQ, NT = q.shape[1], t.shape[1]
    dev = moves.device
    if not moves.is_cuda or moves.dtype != torch.uint8 or moves.stride(1) != 1:
        raise ValueError("moves must be a uint8 CUDA tensor with rows of "
                         "contiguous bytes")
    for x, name in ((n, "n"), (si, "si"), (tb, "tb"), (score, "score"),
                    (qlen, "qlen"), (tlen, "tlen")):
        _cuda.need(x, name, torch.int32, (B,), dev)
    _cuda.need(q, "q", torch.uint8, (B, NQ), dev)
    _cuda.need(t, "t", torch.uint8, (B, NT), dev)
    if max_steps <= 0 or NQ < 1 or NT < 1:
        raise ValueError(f"max_steps={max_steps}, NQ={NQ}, NT={NT}: need "
                         "all positive")
    lib = _cuda.get_adaptive_lib()
    stride = strings_stride(max_steps)
    out = torch.empty((B, STRINGS_HEAD + 2 * stride), dtype=torch.uint8,
                      device=dev)
    index, stream = _cuda.launch_target(dev)
    code = lib.agc_tb_strings(
        index, moves.data_ptr(), moves.stride(0), n.data_ptr(),
        si.data_ptr(), tb.data_ptr(), score.data_ptr(), q.data_ptr(), NQ,
        qlen.data_ptr(), t.data_ptr(), NT, tlen.data_ptr(), B, stride,
        out.data_ptr(), stream)
    _cuda.check(lib, code, "tb_strings_kernel launch")
    gapped_strings.launches += 1
    return out


gapped_strings.launches = 0


def decode_strings(row: np.ndarray):
    """(qstr, tstr, qe, te) of one row of :func:`gapped_strings`, as
    :func:`moves_to_strings` returns them; raises IndexError where it
    raises."""
    _, _, _, qe, te, n = row[:24].view(np.int32).tolist()
    if n < 0:
        raise IndexError("a gapped string's index is out of range")
    stride = (len(row) - STRINGS_HEAD) // 2
    tq = STRINGS_HEAD + stride
    return (row[STRINGS_HEAD:STRINGS_HEAD + n].tobytes().decode("ascii"),
            row[tq:tq + n].tobytes().decode("ascii"), qe, te)


# ---------------------------------------------------------------------------
# host-side helpers


def numpy_local_align(q: np.ndarray, t: np.ndarray, match=2, mismatch=-4,
                      gap=-3):
    """Unbanded Smith-Waterman oracle for tests (O(nm), host)."""
    n, m = len(q), len(t)
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        sub = np.where(t == q[i - 1], match, mismatch)
        for p in range(1, m + 1):
            v = max(H[i - 1][p - 1] + sub[p - 1], H[i - 1][p] + gap,
                    H[i][p - 1] + gap, 0)
            H[i][p] = v
            if v > best:
                best, bi, bj = v, i, p
    return int(best), bi, bj


def moves_to_strings(moves_rev: np.ndarray, q_codes: np.ndarray,
                     start_q: int, start_t: int, t_codes: np.ndarray):
    """Reconstruct gapped strings from END->START move codes.

    Returns (qstr, tstr, qe, te) — gapped ASCII strings plus end-exclusive
    coordinates; start_q/start_t are the begin coordinates from traceback.
    """
    moves = moves_rev[moves_rev != 0][::-1]
    q_adv = (moves != LEFT)
    t_adv = (moves != UP)
    qi = start_q + np.cumsum(q_adv) - q_adv
    ti = start_t + np.cumsum(t_adv) - t_adv
    qs = np.where(q_adv, q_codes[np.minimum(qi, len(q_codes) - 1)], 4)
    ts = np.where(t_adv, t_codes[np.minimum(ti, len(t_codes) - 1)], 4)
    table = np.frombuffer(b"ACGT-", dtype=np.uint8)
    qstr = table[qs].tobytes().decode()
    tstr = table[ts].tobytes().decode()
    qe = int(start_q + q_adv.sum())
    te = int(start_t + t_adv.sum())
    return qstr, tstr, qe, te
