"""Adaptive banded local-alignment DP and its traceback, in torch.

Counterpart of ``aligngraph2_tpu/ops/banded_dp.py``, the path the JAX
package takes on the CPU.  Same semantics, value for value:

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

Tensors on the CPU only: the adaptive band on CUDA belongs to the
multi-GPU extender, which has not been ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -(1 << 28)

# direction codes
STOP, DIAG, UP, LEFT = 0, 1, 2, 3


class BandedResult(NamedTuple):
    score: torch.Tensor     # (B,) int32 best local score
    best_i: torch.Tensor    # (B,) int32 query end row (exclusive)
    best_j: torch.Tensor    # (B,) int32 band column of the end cell
    dirs: torch.Tensor      # (B, NQ, W) uint8 direction codes per cell
    centers: torch.Tensor   # (B, NQ+1) int32 band center diagonal per row


def _cpu_i32(x) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if t.device.type != "cpu":
        raise ValueError("the adaptive band runs on CPU tensors only")
    return t.to(torch.int32)


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


def banded_align(q, qlen, t, tlen, c0, *, W=256, match=2, mismatch=-4,
                 gap=-3, x_drop=0) -> BandedResult:
    """Batched adaptive banded local alignment.

    q: (B, NQ) uint8 query codes (aligned strand), qlen: (B,)
    t: (B, NT) uint8 target window codes,           tlen: (B,)
    c0: (B,) initial band center diagonal (t_pos - q_pos estimate,
        relative to the window start)
    x_drop: > 0 enables per-lane early termination (see module docstring).
    """
    q = _cpu_i32(q)
    t = _cpu_i32(t)
    qlen, tlen, c0 = _cpu_i32(qlen), _cpu_i32(tlen), _cpu_i32(c0)
    B, NQ = q.shape
    NT = t.shape[1]
    PADL = W + 2
    # t_pad as in the JAX package, plus W more sentinels on the left so a
    # read before the window (which JAX answers with a sentinel) indexes
    # in bounds
    t_pad = torch.cat([torch.full((B, W + PADL), 255, dtype=torch.int32), t,
                       torch.full((B, W + NQ + 2), 255, dtype=torch.int32)],
                      dim=1)
    L = NT + 2 * W + NQ + 4          # the JAX t_pad length
    xd = x_drop > 0
    c_hi = NT if xd else L
    shifts = ks_shifts(W)
    j_idx = torch.arange(W, dtype=torch.int32)[None, :]
    p0 = c0[:, None] - W // 2 + j_idx
    H = torch.where((p0 >= 0) & (p0 <= tlen[:, None]), 0, NEG
                    ).to(torch.int32)
    c = c0.clone()
    best = torch.zeros(B, dtype=torch.int32)
    b_i = torch.zeros(B, dtype=torch.int32)
    b_j = torch.zeros(B, dtype=torch.int32)
    dirs = torch.zeros((B, NQ, W), dtype=torch.uint8)
    centers = torch.zeros((B, NQ + 1), dtype=torch.int32)
    centers[:, 0] = c0
    alive = torch.ones(B, dtype=torch.bool)
    jl = j_idx.long()
    for i in range(1, NQ + 1):
        if xd and not bool(alive.any()):
            break
        row_max = H.amax(dim=1)
        # torch.argmax, like jnp.argmax, returns the first maximum
        drift = H.argmax(dim=1).to(torch.int32) - W // 2
        dc = torch.where(row_max > 0, drift.clamp(-1, 1), 0).to(torch.int32)
        c_new = (c + dc).clamp(-W, c_hi)
        padded = torch.nn.functional.pad(H, (1, 2), value=NEG)
        diag_vals = padded.gather(1, (dc[:, None] + 1 + jl).long())
        up_vals = padded.gather(1, (dc[:, None] + 2 + jl).long())
        start = (i - 1) + c_new + (PADL - W // 2)
        if not xd:
            # dynamic_slice clamps the start into [0, L - W]
            start = start.clamp(0, L - W)
        t_slice = t_pad.gather(1, (start[:, None] + W + jl).long())
        sub = torch.where(t_slice == q[:, i - 1:i], match, mismatch)
        d_v = diag_vals + sub
        u_v = up_vals + gap
        M = torch.maximum(d_v, u_v)
        m_dir = torch.where(d_v >= u_v, DIAG, UP)
        m_dir = torch.where(M > 0, m_dir, STOP)
        M = M.clamp(min=0)
        Hn = maxplus_scan(M, gap, shifts)
        row_dirs = torch.where(Hn > M, LEFT, m_dir)
        p = i + c_new[:, None] - W // 2 + j_idx
        ok = (p >= 0) & (p <= tlen[:, None]) & (i <= qlen[:, None])
        Hn = torch.where(ok, Hn, NEG).to(torch.int32)
        row_dirs = torch.where(ok, row_dirs, STOP)
        if xd:
            # dead lanes freeze: state unchanged, dirs stay STOP
            Hn = torch.where(alive[:, None], Hn, H)
            c_new = torch.where(alive, c_new, c)
            row_dirs = torch.where(alive[:, None], row_dirs, STOP)
        r_max = Hn.amax(dim=1)
        r_arg = Hn.argmax(dim=1).to(torch.int32)
        upd = r_max > best
        if xd:
            upd = upd & alive
        best = torch.where(upd, r_max, best)
        b_i = torch.where(upd, i, b_i).to(torch.int32)
        b_j = torch.where(upd, r_arg, b_j)
        dirs[:, i - 1] = row_dirs.to(torch.uint8)
        centers[:, i] = c_new
        if xd:
            alive = alive & (i < qlen) \
                & ((best == 0) | (r_max >= best - x_drop))
        H, c = Hn, c_new
    return BandedResult(best, b_i, b_j, dirs, centers)


def _jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's rule for a gather index: wrap once if negative, then clamp."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()


def traceback(dirs, centers, best_i, best_j, *, max_steps):
    """Batched traceback of :func:`banded_align`.

    Returns (moves (B, max_steps) uint8 in END->START order, n_moves (B,),
    start_i (B,), start_j (B,)).  Move codes are DIAG/UP/LEFT; 0 entries
    past n_moves are padding.  The loop ends early once every lane has
    stopped (checked every 64 steps); later steps would only write
    padding.
    """
    B, NQ, W = dirs.shape
    i = _cpu_i32(best_i).clone()
    j = _cpu_i32(best_j).clone()
    lanes = torch.arange(B)
    active = torch.ones(B, dtype=torch.bool)
    moves = torch.zeros((B, max_steps), dtype=torch.uint8)
    for step in range(max_steps):
        ii = (i - 1).clamp(min=0)
        cur = dirs[lanes, _jax_index(ii, NQ), _jax_index(j, W)].to(torch.int32)
        cur = torch.where(active & (i > 0), cur, STOP)
        dc = centers[lanes, _jax_index(i, NQ + 1)] \
            - centers[lanes, _jax_index(ii, NQ + 1)]
        ni = torch.where(cur == LEFT, i, i - 1)
        nj = torch.where(cur == LEFT, j - 1,
                         torch.where(cur == DIAG, j + dc, j + dc + 1))
        live = active & (cur != STOP)
        i = torch.where(live, ni, i)
        j = torch.where(live, nj, j)
        active = live
        moves[:, step] = cur.to(torch.uint8)
        if step % 64 == 63 and not bool(active.any()):
            break
    n = (moves != 0).sum(dim=1, dtype=torch.int32)
    return moves, n, i, j


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
