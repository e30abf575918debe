"""Banded Smith-Waterman and its traceback in plain torch: the static band
(standard frame, the single-device path) and the adaptive band (the mesh
path and reads past the 65536 bucket).

A frozen copy of the plain versions the port's CUDA kernels are held to
(``banded_dp_static_ref``, ``traceback_static_ref``, ``banded_align_ref``,
``traceback_ref`` and their helpers), so a later change to the port leaves
the benchmark's yardstick where it was.  Semantics, value for value:
int32 scores, linear gaps, the in-row gap chain as a Kogge-Stone max-plus
scan, x_drop decided per lane (every K rows on the static band, every row
on the adaptive one), JAX's gather rules where a read falls outside.

``cap`` saturates every cell score at that value (the control's int16
arithmetic: ``cap=32767``); None runs int32 as the configuration states.
On a card the rows and moves replay as CUDA graphs of 64.
"""

from __future__ import annotations

import numpy as np
import torch

NEG = -(1 << 28)
STOP, DIAG, UP, LEFT = 0, 1, 2, 3
CHUNK = 64


def ks_shifts(W: int):
    return tuple(1 << s for s in range(int(np.log2(W))))


def maxplus_scan(M, gap, shifts):
    """H[j] = max(H[j], H[j - sh] + gap * sh) for each shift, NEG shifted
    in."""
    H = M
    for sh in shifts:
        shifted = torch.nn.functional.pad(H[..., :-sh], (sh, 0), value=NEG)
        H = torch.maximum(H, shifted + gap * sh)
    return H


def _loop(step, S, n, stop) -> None:
    """S = step(S) n times, asking stop(S) before every CHUNK steps; on a
    card a chunk is captured once as a CUDA graph and replayed."""

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


def _saturate(x, cap):
    return x if cap is None else x.clamp(max=cap)


def static_dp(q, t, qlen, *, W, K=64, match=2, mismatch=-4, gap=-3,
              x_drop=0, cap=None):
    """Static-band DP.  q: (B, NQ) uint8 padded with 254; t: (B, NQ + W)
    standard-frame windows (cell (i, j) reads t[i-1+j]) padded with 255;
    qlen (B,) int32.  Returns (score, best_i, best_j, words (B, NQ/16, W)
    int32 packed 2-bit directions, rows)."""
    B, NQ = q.shape
    dev = q.device
    q32 = q.to(torch.int32)
    t32 = t.to(torch.int32)
    qlen = qlen.to(torch.int32)
    shifts = ks_shifts(W)
    words = torch.zeros((B, NQ // 16, W), dtype=torch.int32, device=dev)
    j_idx = torch.arange(W, dtype=torch.int64, device=dev)
    match_t, mismatch_t = (torch.tensor(x, dtype=torch.int32, device=dev)
                           for x in (match, mismatch))
    zero = torch.zeros((B, W), dtype=torch.int32, device=dev)
    S = dict(H=zero, bcol=zero.clone(), brow=zero.clone(), acc=zero.clone(),
             alive=torch.ones((B, 1), dtype=torch.bool, device=dev),
             rows=torch.full((B,), NQ, dtype=torch.int32, device=dev),
             i=torch.ones((), dtype=torch.int64, device=dev))

    def row(S):
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
        M = _saturate(M.clamp(min=0), cap)
        Hn = _saturate(maxplus_scan(M, gap, shifts), cap)
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
            front = Hn.amax(dim=1, keepdim=True)
            best = nxt["bcol"].amax(dim=1, keepdim=True)
            ok = (i + 1 <= qlen[:, None]) \
                & ((best == 0) | (front >= best - x_drop))
            died = alive & ~ok & ((i % K == 0) & (i < NQ))
            nxt["rows"] = torch.where(died[:, 0], i.to(torch.int32),
                                      S["rows"])
            nxt["alive"] = alive & ~died
        return nxt

    _loop(row, S, NQ, lambda S: x_drop > 0 and not bool(S["alive"].any()))
    bcol, brow = S["bcol"], S["brow"]
    score = bcol.amax(dim=1)
    mask = bcol == score[:, None]
    istar = torch.where(mask, brow, 1 << 30).amin(dim=1)
    jstar = torch.where(mask & (brow == istar[:, None]),
                        j_idx[None, :].to(torch.int32), W).amin(dim=1)
    istar = torch.where(score > 0, istar, 0).to(torch.int32)
    jstar = torch.where(score > 0, jstar, 0).to(torch.int32)
    return score, istar, jstar, words, S["rows"]


def static_traceback(words, best_i, best_j, *, max_steps):
    """Walk the packed words from (best_i, best_j).  Returns (moves (B,
    max_steps) uint8 END->START, start_i, start_j)."""
    B, NW, W = words.shape
    dev = words.device
    lanes = torch.arange(B, device=dev)
    moves = torch.zeros((B, max_steps), dtype=torch.uint8, device=dev)

    def walk(S):
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
    return moves, S["i"], S["j"]


def adaptive_dp(q, qlen, t, tlen, c0, *, W=256, match=2, mismatch=-4,
                gap=-3, x_drop=0, cap=None, nt=None):
    """Adaptive-band DP: a band of W cells whose centre drifts by at most
    one a row toward the previous row's first maximum.  q (B, NQ) uint8,
    t (B, NT) uint8 window codes, qlen/tlen/c0 (B,) int32 (c0: the first
    centre, t position minus q position in the window).  With x_drop, the
    centre is clipped to each lane's window length: NT, or ``nt`` (B,)
    where lanes of shorter windows share the batch.  Returns (score,
    best_i, best_j, dirs (B, NQ, W) uint8, centers (B, NQ + 1) int32)."""
    dev = q.device
    q = q.to(torch.int32)
    t = t.to(torch.int32)
    qlen, tlen, c0 = (x.to(torch.int32) for x in (qlen, tlen, c0))
    B, NQ = q.shape
    NT = t.shape[1]
    PADL = W + 2
    t_pad = torch.cat([torch.full((B, W + PADL), 255, dtype=torch.int32,
                                  device=dev), t,
                       torch.full((B, W + NQ + 2), 255, dtype=torch.int32,
                                  device=dev)], dim=1)
    L = NT + 2 * W + NQ + 4
    xd = x_drop > 0
    c_hi = L if not xd else (
        torch.full((B,), NT, dtype=torch.int32, device=dev) if nt is None
        else nt.to(device=dev, dtype=torch.int32))
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
             last=zeros.clone(),
             i=torch.ones((), dtype=torch.int32, device=dev))
    du_idx = torch.arange(1, W + 2, device=dev)[None, :]
    t_idx = j_idx.long() + W
    match_t, mismatch_t = (torch.tensor(x, dtype=torch.int32, device=dev)
                           for x in (match, mismatch))
    diag8, up8 = (torch.tensor(x, dtype=torch.uint8, device=dev)
                  for x in (DIAG, UP))

    def row(S):
        i, H, c, alive = S["i"], S["H"], S["c"], S["alive"]
        i1 = (i - 1).long().view(1)
        row_max, arg = H.max(dim=1)
        drift = arg.to(torch.int32) - W // 2
        dc = torch.where(row_max > 0, drift.clamp(-1, 1), 0)
        c_new = torch.minimum((c + dc).clamp(min=-W), c_hi) if xd \
            else (c + dc).clamp(-W, c_hi)
        padded = torch.nn.functional.pad(H, (1, 2), value=NEG)
        du = padded.gather(1, dc[:, None] + du_idx)
        start = c_new + (i + (PADL - W // 2 - 1))
        if not xd:
            start = start.clamp(0, L - W)
        t_slice = t_pad.gather(1, start[:, None] + t_idx)
        q_col = q.gather(1, i1.expand(B, 1))
        sub = torch.where(t_slice == q_col, match_t, mismatch_t)
        d_v = du[:, :W] + sub
        u_v = du[:, 1:] + gap
        M = torch.maximum(d_v, u_v)
        m_dir = torch.where(d_v >= u_v, diag8, up8)
        m_dir = torch.where(M > 0, m_dir, STOP)
        M = _saturate(M.clamp(min=0), cap)
        Hn = _saturate(maxplus_scan(M, gap, shifts), cap)
        row_dirs = torch.where(Hn > M, LEFT, m_dir)
        p = c_new[:, None] + (j_idx + (i - W // 2))
        ok = (p >= 0) & (p <= tlen[:, None]) & (i <= qlen[:, None])
        Hn = torch.where(ok, Hn, NEG)
        row_dirs = torch.where(ok, row_dirs, STOP)
        if xd:
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

    _loop(row, S, NQ, lambda S: xd and not bool(S["alive"].any()))
    if xd:
        centers[:, int(S["last"].max()) + 1:] = 0
    return S["best"], S["b_i"], S["b_j"], dirs, centers


def _jax_index(idx, n):
    """JAX's rule for a gather index: wrap once if negative, then clamp."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()


def adaptive_traceback(dirs, centers, best_i, best_j, *, max_steps):
    """Walk the adaptive band's directions.  Returns (moves (B, max_steps)
    uint8 END->START, start_i, start_j)."""
    B, NQ, W = dirs.shape
    dev = dirs.device
    lanes = torch.arange(B, device=dev)
    moves = torch.zeros((B, max_steps), dtype=torch.uint8, device=dev)

    def walk(S):
        i, j, active = S["i"], S["j"], S["active"]
        ii = (i - 1).clamp(min=0)
        iil = ii.long()
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

    S = dict(i=best_i.to(torch.int32).clone(),
             j=best_j.to(torch.int32).clone(),
             active=torch.ones(B, dtype=torch.bool, device=dev),
             step=torch.zeros((), dtype=torch.int32, device=dev))
    _loop(walk, S, max_steps, lambda S: not bool(S["active"].any()))
    return moves, S["i"], S["j"]


def adaptive_start_column(si, sj, centers, W):
    """The window column of the alignment's start: si + centers[si] -
    W/2 + sj, the centre read by JAX's gather rule."""
    c = centers.gather(1, _jax_index(si, centers.shape[1])[:, None])
    return si + c.squeeze(1) - W // 2 + sj
