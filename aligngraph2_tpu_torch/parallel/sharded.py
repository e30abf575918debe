"""Sharded alignment: block-sharded genome seeding and data-parallel
banded extension over the (data, block) device mesh.

Counterpart of ``aligngraph2_tpu/parallel/sharded.py``, the mesh path of
``LongReadAligner.align_reads`` (the single-device path keeps host
seeding and the static band):

  1. the target genome is chopped into overlapping blocks; each block's
     k-mers are indexed (``build_block_index``, a numpy copy) and the
     index is split over the ``block`` mesh axis, each block shard on
     every device of its mesh column (``put_sharded_index``);
  2. SEED: reads are split over the ``data`` axis; each (data, block)
     device scores its rows against its blocks — per (read, strand,
     block) a diagonal-bin hit histogram with adjacent-bin smoothing and
     per-block top-K bins (``_seed_block_candidates``); the tables of a
     data row are concatenated in block order on the row's first device
     (the JAX ``all_gather``), and a greedy near-diagonal dedup plus the
     alpha/beta hit-count clamp selects each read's top-K candidates
     (``_select_read_candidates``);
  3. the host compacts the (read, candidate) table to live lanes only and
     gathers each lane's target window (``align/aligner.py``);
  4. EXTEND: the adaptive banded DP and its traceback
     (``ops/banded_dp.py``: CUDA kernels on a card, the plain torch
     versions on the CPU) on the live lanes, split over every device of
     the mesh (``_extend_body``).

The JAX functions are XLA, not Pallas.  Their plain versions here
(``_seed_reads_ref``: ``kmer_codes_batch`` and
``_seed_block_candidates_ref`` a strand; ``_select_read_candidates_ref``)
are torch ops, value for value: int32 arithmetic that wraps where JAX's
wraps, floor division, ``lax.top_k``'s tie rule (the lower bin first) and
float32 clamp arithmetic; the dedup's sequential loop goes through
``ops/banded_dp.py``'s ``_loop``.  ``_seed_reads`` and
``_select_read_candidates`` take the plain versions on CPU tensors and on
CUDA tensors launch ``seed_block_kernel`` (the k-mer codes and both
strands in one launch) and ``select_candidates_kernel`` of
``csrc/seed_mesh.cu`` (:func:`seed_block`, :func:`select_candidates`,
which count their launches in ``.launches``), or raise.  The seeder and
the extender queue every shard's work before they copy any result back,
so several cards overlap; a shard whose rows are all padding (length 0)
is not run, since such a row yields no candidate and such a lane scores
0.

Outputs are bit-identical for any mesh shape: the per-block tables and
their order do not depend on shard boundaries, host compaction is
deterministic, and extension lanes are independent.

Deviations from the host seeding path (``ops/seedextend.py``), kept from
the JAX package's design for fixed shapes: a bin's diagonal estimate is
the integer mean of its members' diagonals (host: median), and at most
``occ`` occurrences per (query k-mer, block) are enumerated (host: all
up to ``max_occ``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..io.seqdb import SeqDatabase
from ..ops.banded_dp import _jax_index, _loop, banded_align, traceback
from ..ops.kmer import kmer_codes_batch, kmer_codes_np

INT32_MAX = np.iinfo(np.int32).max

# (blocks x query positions) elements one pass of
# _seed_block_candidates_ref holds per array
_SEED_CELLS = 1 << 22
# the kept-entry table slots a read's dedup holds in shared memory
# (kSelSharedSlots of csrc/seed_mesh.cu); a larger table goes to the
# scratch the wrapper allocates
SELECT_SHARED_SLOTS = 1 << 14
# the dynamic shared memory a block of seed_block_kernel may take (its
# bins): 227 KB less its static arrays (the top-T rounds' two reduction
# rows and the touched count); past it the bins go to a global scratch
SEED_SMEM_MAX = 232448 - 272
# the bins' scratch one launch of seed_block_kernel may take when they are
# past SEED_SMEM_MAX: the index blocks go in groups that fit it
SEED_SCRATCH_BYTES = 1 << 29
# seed_block_kernel's directory of a block's codes: 2^SEED_DIR_BITS code
# ranges (kDirBits); its threads a block (kSeedThreads)
SEED_DIR_BITS = 16
SEED_THREADS = 512


class BlockIndex(NamedTuple):
    """Genome split into overlapping blocks with per-block k-mer indexes."""
    blocks: np.ndarray        # (NB, BL) uint8 codes (pad rows = 0)
    block_lens: np.ndarray    # (NB,) int32 (0 for pad rows)
    block_seq: np.ndarray     # (NB,) int32 originating target sequence id
    block_start: np.ndarray   # (NB,) int32 start offset within that
                              # sequence (per-sequence coords < 2^31)
    sorted_codes: np.ndarray  # (NB, L) int32 sorted k-mer codes, pad=INT32_MAX
    sorted_pos: np.ndarray    # (NB, L) int32 in-block k-mer positions
    k: int
    block_len: int
    overlap: int


def build_block_index(db: SeqDatabase, k: int, block_len: int,
                      overlap: int | None = None,
                      pad_blocks_to: int = 1) -> BlockIndex:
    """Chop every target sequence into overlapping blocks and index each
    block's k-mers.  Overlap (default a quarter block) keeps alignments
    near block boundaries findable in at least one block; ``pad_blocks_to``
    pads the block count to a multiple (empty rows) so the arrays split
    evenly over the block mesh axis."""
    if overlap is None:
        overlap = block_len // 4
    # int32 sorted-code arrays bound the device index to k <= 15
    # (AlignerConfig.seed_k_max defaults to 15 for this reason)
    if k > 15:
        raise ValueError(f"block index supports k <= 15, got {k}")
    stride = max(block_len - overlap, 1)
    pieces = []  # (seq_id, start, codes)
    for i in range(len(db)):
        codes = db.get_codes(i)
        for s in range(0, max(len(codes) - overlap, 1), stride):
            piece = codes[s:s + block_len]
            if len(piece) < k:
                continue
            pieces.append((i, s, piece))
    nb = len(pieces)
    nb_pad = max(((nb + pad_blocks_to - 1) // pad_blocks_to)
                 * pad_blocks_to, pad_blocks_to)
    idx_len = max((len(p) - k + 1 for _, _, p in pieces), default=1)
    blocks = np.zeros((nb_pad, block_len), np.uint8)
    lens = np.zeros(nb_pad, np.int32)
    seq_id = np.zeros(nb_pad, np.int32)
    start = np.zeros(nb_pad, np.int32)
    s_codes = np.full((nb_pad, idx_len), INT32_MAX, np.int32)
    s_pos = np.zeros((nb_pad, idx_len), np.int32)
    for bi, (sid, st, piece) in enumerate(pieces):
        blocks[bi, :len(piece)] = piece
        lens[bi] = len(piece)
        seq_id[bi] = sid
        start[bi] = st
        kc = kmer_codes_np(piece, k)
        order = np.argsort(kc, kind="stable")
        s_codes[bi, :len(kc)] = kc[order]
        s_pos[bi, :len(kc)] = order
    return BlockIndex(blocks, lens, seq_id, start, s_codes, s_pos,
                      k, block_len, overlap)


def _on(dev: torch.device):
    """Make ``dev`` the current card while a shard's work is queued (CUDA
    graphs are captured on the current card)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


# ---------------------------------------------------------------------------
# SEED step


def _seed_block_candidates_ref(q_codes, q_valid, sorted_codes, sorted_pos,
                               *, NQ, nbins, bin_w, occ, max_occ, top_t):
    """Per (stream, local block): top-T candidate diagonal bins; the plain
    version.

    q_codes/q_valid: (S, NK) int32/bool; sorted_codes/pos: (NB_l, L)
    int32, on one device.  Returns cnt (S, NB_l, T) int32 smoothed hit
    counts and diag (S, NB_l, T) int32 block-local diagonal estimates.
    Blocks go in groups that bound the working set."""
    S, NK = q_codes.shape
    NB, L = sorted_codes.shape
    dev = q_codes.device
    qpos = torch.arange(NK, dtype=torch.int32, device=dev)
    # lax.top_k's order: count descending, the lower bin first among equal
    # counts; the key is unique per bin, so topk has no tie to break
    tie = (nbins - 1) - torch.arange(nbins, dtype=torch.int64, device=dev)
    cnts, diags = [], []
    per = max(1, _SEED_CELLS // max(S * NK, 1))
    for b0 in range(0, NB, per):
        sc = sorted_codes[b0:b0 + per]
        sp = sorted_pos[b0:b0 + per]
        nb = sc.shape[0]
        qc = q_codes.reshape(1, S * NK).expand(nb, S * NK).contiguous()
        lo = torch.searchsorted(sc, qc, out_int32=True)
        n = (torch.searchsorted(sc, qc, right=True, out_int32=True)
             - lo).view(nb, S, NK)
        lo = lo.view(nb, S, NK)
        ok = q_valid[None] & (n > 0) & (n <= max_occ)
        hist = torch.zeros((nb, S, nbins + 1), dtype=torch.int32,
                           device=dev)
        dsum = torch.zeros_like(hist)
        for o in range(occ):
            hit = ok & (o < n)
            at = (lo + o).clamp(max=L - 1).view(nb, S * NK).long()
            diag = sp.gather(1, at).view(nb, S, NK) - qpos + NQ
            b = (diag // bin_w).clamp(0, nbins - 1)
            b = torch.where(hit, b, nbins).long()   # spill slot for non-hits
            hist.scatter_add_(2, b, torch.ones_like(diag))
            dsum.scatter_add_(2, b, torch.where(hit, diag, 0))
        hist, dsum = hist[..., :nbins], dsum[..., :nbins]
        # adjacent-bin pair smoothing (ops/seedextend.py's bin+1 credit)
        sm_h = hist + torch.nn.functional.pad(hist[..., 1:], (0, 1))
        sm_d = dsum + torch.nn.functional.pad(dsum[..., 1:], (0, 1))
        bidx = (sm_h.long() * nbins + tie).topk(top_t, dim=-1).indices
        cnt = sm_h.gather(-1, bidx)
        d = sm_d.gather(-1, bidx)
        cnts.append(cnt)
        diags.append(torch.where(cnt > 0, d // cnt.clamp(min=1) - NQ, 0))
    # (NB_l, S, T) -> (S, NB_l, T)
    return (torch.cat(cnts).permute(1, 0, 2),
            torch.cat(diags).permute(1, 0, 2))


def _select_read_candidates_ref(cnt, tid, gdiag, *, K, min_hits, alpha,
                                beta, bin_w, prune=0.0):
    """Global per-read candidate selection over the gathered table; the
    plain version.

    cnt/gdiag: (B, N) int32; tid: (N,) or (B, N) int32 — per read the
    flattened (strand, block, T) candidates, fwd strand first then
    block-ascending (strand is folded into ``tid`` by sign so dedup never
    merges across strands).  Returns (sel (B, K) bool, idx (B, K) int32
    into the flat arrays, score (B, K) float32)."""
    B, N = cnt.shape
    dev = cnt.device
    tid = tid.expand(B, N)
    valid = cnt >= min_hits
    # stable cnt-descending order (ties keep enumeration order, matching
    # the host's stable sort in _finalize_read_candidates)
    order = torch.sort(-cnt, dim=1, stable=True).indices
    s_cnt = cnt.gather(1, order)
    s_tid = tid.gather(1, order)
    s_gd = gdiag.gather(1, order)
    s_valid = valid.gather(1, order)

    def step(S):
        """Candidate S["i"]: kept iff valid and no kept candidate before it
        lies on the same strand and target within bin_w diagonals."""
        i1 = S["i"].view(1)
        kept = S["kept"]
        near = kept & (s_tid == s_tid.index_select(1, i1)) \
            & ((s_gd - s_gd.index_select(1, i1)).abs() <= bin_w)
        keep = s_valid.index_select(1, i1) & ~near.any(1, keepdim=True)
        kept.index_copy_(1, i1, keep)
        return dict(kept=kept, i=S["i"] + 1)

    S = dict(kept=torch.zeros((B, N), dtype=torch.bool, device=dev),
             i=torch.zeros((), dtype=torch.int64, device=dev))
    _loop(step, S, N, lambda S: False)
    kept = S["kept"]

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    n_kept = kept.sum(1, dtype=torch.int32).clamp(min=1)
    mean = torch.where(kept, s_cnt, 0).float().sum(1) / n_kept.float()
    score = torch.clamp(s_cnt.float(), min=(f32(alpha) * mean)[:, None],
                        max=(f32(beta) * mean)[:, None])
    if prune > 0.0:
        # pre-extension prune on the CLAMPED score, in float32 as the host
        # path does (ops/seedextend.py _finalize_read_candidates)
        best_s = torch.where(kept, score, 0).amax(1)
        kept = kept & (score >= f32(prune) * best_s[:, None])
    # the clamp is monotone, so cnt-descending kept order IS
    # score-descending: the global top-K are the first K kept entries
    krank = kept.cumsum(1, dtype=torch.int32) - 1
    pick = kept & (krank < K)
    slot = torch.where(pick, krank, K).long()

    def place(src, dtype):
        out = torch.zeros((B, K + 1), dtype=dtype, device=dev)
        return out.scatter_(1, slot, src.to(dtype))[:, :K]

    return (place(pick, torch.bool), place(order, torch.int32),
            place(score, torch.float32))


def _seed_reads_ref(q_fwd, q_rev, read_lens, sorted_codes, sorted_pos, *,
                    k, NQ, nbins, bin_w, occ, max_occ, top_t):
    """Both strands of a batch of reads against one device's blocks; the
    plain version: each strand's k-mer codes (``kmer_codes_batch``), then
    :func:`_seed_block_candidates_ref`.  q_fwd/q_rev: (B, NQ) uint8 codes,
    read_lens (B,) int32.  Returns cnt and diag (B, 2, NB_l, T) int32,
    the forward strand first."""
    kw = dict(NQ=NQ, nbins=nbins, bin_w=bin_w, occ=occ, max_occ=max_occ,
              top_t=top_t)
    per_strand = [_seed_block_candidates_ref(
        *kmer_codes_batch(q, read_lens, k), sorted_codes, sorted_pos, **kw)
        for q in (q_fwd, q_rev)]
    return (torch.stack([c for c, _ in per_strand], 1),
            torch.stack([d for _, d in per_strand], 1))


def _seed_reads(q_fwd, q_rev, read_lens, sorted_codes, sorted_pos,
                seed_dir, *, k, NQ, nbins, bin_w, occ, max_occ, top_t):
    """Both strands of a batch of reads against one device's blocks, cnt
    and diag (B, 2, NB_l, T) int32: :func:`seed_block` on CUDA tensors,
    the plain version on CPU tensors (arguments as
    :func:`_seed_reads_ref`, and the blocks' :func:`seed_directory`, which
    only the kernel reads: None will do on the CPU)."""
    kw = dict(k=k, NQ=NQ, nbins=nbins, bin_w=bin_w, occ=occ,
              max_occ=max_occ, top_t=top_t)
    if q_fwd.device.type == "cpu":
        return _seed_reads_ref(q_fwd, q_rev, read_lens, sorted_codes,
                               sorted_pos, **kw)
    return seed_block(q_fwd, q_rev, read_lens, sorted_codes, sorted_pos,
                      seed_dir, **kw)


def _select_read_candidates(cnt, tid, gdiag, *, K, min_hits, alpha, beta,
                            bin_w, prune=0.0):
    """Global per-read candidate selection, (sel, idx, score) each (B, K):
    :func:`select_candidates` on CUDA tensors, the plain version on CPU
    tensors (arguments as :func:`_select_read_candidates_ref`)."""
    kw = dict(K=K, min_hits=min_hits, alpha=alpha, beta=beta, bin_w=bin_w,
              prune=prune)
    if cnt.device.type == "cpu":
        return _select_read_candidates_ref(cnt, tid, gdiag, **kw)
    return select_candidates(cnt, tid, gdiag, **kw)


def _need_int32(**values) -> None:
    """Raise unless every value fits the kernels' int arguments."""
    for name, v in values.items():
        if not -(1 << 31) <= int(v) < 1 << 31:
            raise ValueError(f"{name}={v} does not fit int32")


def seed_smem_bytes(nbins: int) -> int:
    """The bytes of one (stream, index block) pair's bins in
    seed_block_kernel: hist, dsum and the touched bins' list, nbins int32
    each."""
    return 3 * nbins * 4


def seed_bins_in_scratch(nbins: int) -> bool:
    """Whether seed_block_kernel keeps a pair's bins in a global scratch
    (they pass SEED_SMEM_MAX, 19,348 bins) rather than in its cluster
    leader's shared memory."""
    return seed_smem_bytes(nbins) > SEED_SMEM_MAX


def seed_launch_blocks(NB: int, S: int, nbins: int) -> int:
    """The index blocks one launch of seed_block_kernel takes for S
    streams: all NB when the bins are in shared memory, else as many as
    SEED_SCRATCH_BYTES holds at seed_smem_bytes(nbins) a (stream, block)
    pair, at least one."""
    if not seed_bins_in_scratch(nbins):
        return NB
    return max(1, min(NB, SEED_SCRATCH_BYTES // (S * seed_smem_bytes(nbins))))


def seed_dir_shift(k: int) -> int:
    """The directory's shift for k-mer codes below 4^k: 2^SEED_DIR_BITS
    ranges of 2^shift codes cover them."""
    return max(2 * k - SEED_DIR_BITS, 0)


def seed_directory(sorted_codes: torch.Tensor, k: int) -> torch.Tensor:
    """The directory seed_block_kernel starts each search from, made once
    an index on the codes' device: (NB, 2^SEED_DIR_BITS + 3) int32, row b
    0, then for j = 0 .. 2^SEED_DIR_BITS the first index of
    sorted_codes[b] whose code is not below j << seed_dir_shift(k), then
    L.  A code c's lower bound and the end of its run lie between entries
    h + 1 and h + 2 of h = c >> shift clamped to [-1, 2^SEED_DIR_BITS]."""
    NB, L = sorted_codes.shape
    dev = sorted_codes.device
    bounds = torch.arange((1 << SEED_DIR_BITS) + 1, dtype=torch.int32,
                          device=dev) << seed_dir_shift(k)
    out = torch.empty((NB, (1 << SEED_DIR_BITS) + 3), dtype=torch.int32,
                      device=dev)
    out[:, 0] = 0
    out[:, -1] = L
    for b0 in range(0, NB, 64):
        sc = sorted_codes[b0:b0 + 64]
        out[b0:b0 + 64, 1:-1] = torch.searchsorted(
            sc, bounds.expand(sc.shape[0], -1).contiguous(),
            out_int32=True)
    return out


def seed_grid(NB: int, S: int, NK: int, sms: int) -> int:
    """The blocks a cluster (C) of seed_block_kernel for NB index blocks
    and S streams of NK positions on a card of ``sms`` SMs: one block an
    (index block, stream) pair where there are 8 pairs an SM or more,
    else the largest power of two up to 8 that brings the blocks toward
    that and leaves each thread four positions or more of its slice."""
    C = 1
    while (C < 8 and NB * S * C < 8 * sms
           and NK // (2 * C) >= 4 * SEED_THREADS):
        C *= 2
    return C


def seed_block(q_fwd, q_rev, read_lens, sorted_codes, sorted_pos, seed_dir,
               *, k, NQ, nbins, bin_w, occ, max_occ, top_t):
    """Launch ``seed_block_kernel`` on CUDA tensors: q_fwd and q_rev uint8
    (B, NQ), read_lens int32 (B,), sorted_codes and sorted_pos int32
    (NB_l, L) and their :func:`seed_directory` for this k, all on one
    card and contiguous.  Both strands' k-mer codes are made in the
    kernel.  Returns contiguous cnt and diag (B, 2, NB_l, T) int32.
    Any nbins: past SEED_SMEM_MAX the bins are in a scratch allocated
    here, and the index blocks go in launches of
    :func:`seed_launch_blocks` each (each launch counts).  Raises on any
    input the kernel does not take."""
    from ..ops import _cuda
    B, NQ_ = q_fwd.shape
    NB, L = sorted_codes.shape
    dev = q_fwd.device
    _cuda.need(q_fwd, "q_fwd", torch.uint8, (B, NQ_))
    _cuda.need(q_rev, "q_rev", torch.uint8, (B, NQ_), dev)
    _cuda.need(read_lens, "read_lens", torch.int32, (B,), dev)
    _cuda.need(sorted_codes, "sorted_codes", torch.int32, (NB, L), dev)
    _cuda.need(sorted_pos, "sorted_pos", torch.int32, (NB, L), dev)
    _cuda.need(seed_dir, "seed_dir", torch.int32,
               (NB, (1 << SEED_DIR_BITS) + 3), dev)
    _need_int32(NQ=NQ, occ=occ, max_occ=max_occ, nbins=nbins)
    NK = NQ - k + 1
    if not (NQ_ == NQ and 0 < B and 1 <= k <= 15 and NK > 0
            and 0 < NB <= 65535 and L > 0 and bin_w > 0
            and 0 < top_t <= nbins and occ >= 0 and max_occ >= 0
            and NK * occ < 1 << 30):
        raise ValueError(
            f"B={B}, NQ={NQ} (q: {NQ_}), k={k}, NB={NB}, L={L}, "
            f"bin_w={bin_w}, top_t={top_t}, nbins={nbins}, occ={occ}, "
            f"max_occ={max_occ}: need q's width NQ, B, L and bin_w "
            f"positive, 1 <= k <= min(15, NQ), NB <= 65535, 0 < top_t <= "
            f"nbins, occ and max_occ >= 0, (NQ - k + 1) * occ < 2^30")
    lib = _cuda.get_seed_lib()
    cnt, diag = (torch.empty((B, 2, NB, top_t), dtype=torch.int32,
                             device=dev) for _ in range(2))
    per = seed_launch_blocks(NB, 2 * B, nbins)
    scratch = (torch.empty(per * 2 * B * 3 * nbins, dtype=torch.int32,
                           device=dev)
               if seed_bins_in_scratch(nbins) else None)
    index, stream = _cuda.launch_target(dev)
    C = seed_grid(NB, 2 * B, NK, _cuda.sm_count(index))
    for b0 in range(0, NB, per):
        code = lib.agc_seed_block(
            index, q_fwd.data_ptr(), q_rev.data_ptr(), read_lens.data_ptr(),
            sorted_codes.data_ptr(), sorted_pos.data_ptr(),
            seed_dir.data_ptr(), B, NQ, k, NB, L, nbins, bin_w, occ,
            max_occ, top_t, C, b0, min(per, NB - b0),
            None if scratch is None else scratch.data_ptr(),
            cnt.data_ptr(), diag.data_ptr(), stream)
        _cuda.check(lib, code, "seed_block_kernel launch")
        seed_block.launches += 1
    return cnt, diag


seed_block.launches = 0


def select_slots(N: int) -> int:
    """select_candidates_kernel's table slots for N candidates a read: a
    power of two at least 2N (a load of at most one half), at least 64."""
    return max(64, 1 << (2 * N - 1).bit_length())


def select_candidates(cnt, tid, gdiag, *, K, min_hits, alpha, beta, bin_w,
                      prune=0.0):
    """Launch ``select_candidates_kernel`` on CUDA tensors: cnt and gdiag
    int32 (B, N), tid int32 (N,) or (B, N), all on one card and
    contiguous; the stable cnt-descending order is one torch.sort here.
    Returns (sel (B, K) bool, idx (B, K) int32, score (B, K) float32).
    Raises on any input the kernel does not take, among them bin_w
    outside [0, 2^30]."""
    from ..ops import _cuda
    B, N = cnt.shape
    dev = cnt.device
    _cuda.need(cnt, "cnt", torch.int32, (B, N))
    _cuda.need(tid, "tid", torch.int32,
               (N,) if tid.dim() == 1 else (B, N), dev)
    _cuda.need(gdiag, "gdiag", torch.int32, (B, N), dev)
    _need_int32(min_hits=min_hits)
    if B <= 0 or N <= 0 or not 0 < K < 1 << 31 or N >= 1 << 29 \
            or not 0 <= bin_w <= 1 << 30:
        raise ValueError(f"B={B}, N={N}, K={K}, bin_w={bin_w}: need B, N "
                         f"and K positive, N < 2^29, 0 <= bin_w <= 2^30")
    lib = _cuda.get_seed_lib()
    order = torch.sort(-cnt, dim=1, stable=True).indices
    slots = select_slots(N)
    # a read's (order index, count) of every kept entry, then its table of
    # kept entries when it does not fit the shared slots
    scratch = torch.empty(
        (B, N + (slots if slots > SELECT_SHARED_SLOTS else 0)),
        dtype=torch.int64, device=dev)
    sel = torch.empty((B, K), dtype=torch.bool, device=dev)
    idx = torch.empty((B, K), dtype=torch.int32, device=dev)
    score = torch.empty((B, K), dtype=torch.float32, device=dev)
    index, stream = _cuda.launch_target(dev)
    code = lib.agc_select_candidates(
        index, cnt.data_ptr(), tid.data_ptr(), gdiag.data_ptr(),
        order.data_ptr(), B, N, 0 if tid.dim() == 1 else N, K, min_hits,
        alpha, beta, bin_w, int(prune > 0.0), prune, slots,
        scratch.data_ptr(), sel.data_ptr(), idx.data_ptr(),
        score.data_ptr(), stream)
    _cuda.check(lib, code, "select_candidates_kernel launch")
    select_candidates.launches += 1
    return sel, idx, score


select_candidates.launches = 0


def _seed_body(q_fwd, q_rev, read_lens, index_row, *, k, BL, bin_w,
               min_hits, occ, max_occ, alpha, beta, K, prune):
    """One data row of the mesh: seed its reads against every block shard
    and select each read's top-K candidates.

    q_fwd/q_rev: (B, NQ) uint8 and read_lens (B,) on the row's first
    device; index_row: one (block_seq, block_start, sorted_codes,
    sorted_pos, seed_dir) per block shard, each on its device.  Returns (sel,
    c_block, c_strand, c_diag, c_cnt, score), each (B, K), on the row's
    first device."""
    B, NQ = q_fwd.shape
    home = q_fwd.device
    nbins = int(np.ceil((BL + NQ) / bin_w)) + 2
    cnts, diags, g_seq, g_start = [], [], [], []
    for bseq, bstart, sc, sp, sdir in index_row:
        dev = sc.device
        with _on(dev):
            cnt, diag = _seed_reads(
                *(x.to(dev, non_blocking=True)
                  for x in (q_fwd, q_rev, read_lens)), sc, sp, sdir, k=k,
                NQ=NQ, nbins=nbins, bin_w=bin_w, occ=occ, max_occ=max_occ,
                top_t=K)
        # (B, 2, NB_l, T), gathered on the row's first device in block
        # order (the JAX all_gather over the block axis)
        cnts.append(cnt.to(home))
        diags.append(diag.to(home))
        g_seq.append(bseq.to(home))
        g_start.append(bstart.to(home))
    cnt = torch.cat(cnts, 2)
    diag = torch.cat(diags, 2)
    g_seq = torch.cat(g_seq)
    g_start = torch.cat(g_start)

    NBg = g_seq.shape[0]
    N = 2 * NBg * K
    # flat per-candidate metadata, fwd strand first then rev (the host
    # enumerates fwd/rev streams in that order)
    strand_f = torch.tensor([1, 0], dtype=torch.int32,
                            device=home).repeat_interleave(NBg * K)
    block_f = torch.arange(NBg, dtype=torch.int32,
                           device=home).repeat_interleave(K).repeat(2)
    cnt2 = cnt.reshape(B, N)
    diag2 = diag.reshape(B, N)
    bl = block_f.long()
    tid_f = (g_seq[bl] + 1) * torch.where(strand_f == 1, 1, -1).int()
    gdiag2 = g_start[bl][None, :] + diag2
    sel, idx, score = _select_read_candidates(
        cnt2, tid_f, gdiag2, K=K, min_hits=min_hits, alpha=alpha, beta=beta,
        bin_w=bin_w, prune=prune)
    il = idx.long()
    return (sel, block_f[il], strand_f[il] == 1, diag2.gather(1, il),
            cnt2.gather(1, il), score)


def make_sharded_seeder(mesh, *, k, BL, bin_w, min_hits, occ=4,
                        max_occ=256, alpha=0.5, beta=2.0, K=8, prune=0.0):
    """The seed step over ``mesh``: a callable
    ``(q_fwd, q_rev, read_lens, *put_sharded_index(...))`` of host arrays
    (B rows, B a multiple of the data axis) returning host arrays (sel,
    c_block, c_strand, c_diag, c_cnt, score), each (B, K), in row order."""
    data_par = mesh.devices.shape[0]
    kw = dict(k=k, BL=BL, bin_w=bin_w, min_hits=min_hits, occ=occ,
              max_occ=max_occ, alpha=alpha, beta=beta, K=K, prune=prune)

    def seeder(q_fwd, q_rev, read_lens, block_lens, block_seq, block_start,
               sorted_codes, sorted_pos, seed_dirs):
        B = len(read_lens)
        per = B // data_par
        outs = []
        for d in range(data_par):
            rows = slice(d * per, (d + 1) * per)
            if not np.any(read_lens[rows]):
                outs.append(None)   # padding rows only
                continue
            home = mesh.devices[d, 0]
            with _on(home):
                q_f, q_r, ln = (torch.from_numpy(np.ascontiguousarray(
                    x[rows])).to(home, non_blocking=True)
                    for x in (q_fwd, q_rev, read_lens))
                outs.append(_seed_body(
                    q_f, q_r, ln,
                    [(block_seq[d, b], block_start[d, b],
                      sorted_codes[d, b], sorted_pos[d, b], seed_dirs[d, b])
                     for b in range(mesh.devices.shape[1])], **kw))
        empty = (np.zeros((per, K), bool), np.zeros((per, K), np.int32),
                 np.ones((per, K), bool), np.zeros((per, K), np.int32),
                 np.zeros((per, K), np.int32),
                 np.zeros((per, K), np.float32))
        return tuple(np.concatenate([
            empty[j] if o is None else o[j].cpu().numpy() for o in outs])
            for j in range(6))

    return seeder


# ---------------------------------------------------------------------------
# EXTEND step


def _extend_body(q, qlen, t, tlen, c0, *, W, match, mismatch, gap, x_drop,
                 max_steps):
    """Adaptive banded DP and traceback of one lane shard, on its device.
    Returns (score, moves, start row si, start window column tb)."""
    res = banded_align(q, qlen, t, tlen, c0, W=W, match=match,
                       mismatch=mismatch, gap=gap, x_drop=x_drop)
    moves, _, si, sj = traceback(res.dirs, res.centers, res.best_i,
                                 res.best_j, max_steps=max_steps)
    # start column -> window coordinate (needs the per-row band centers,
    # which never leave the device): tb = si + centers[si] - W/2 + sj
    cen_si = res.centers.gather(
        1, _jax_index(si, res.centers.shape[1])[:, None]).squeeze(1)
    tb = si + cen_si - W // 2 + sj
    return res.score, moves, si, tb


def make_sharded_extender(mesh, *, W, match=2, mismatch=-4, gap=-3,
                          x_drop=0, max_steps):
    """The extend step with lanes split over ALL devices of ``mesh`` (the
    lane dim is pure data parallelism; both mesh axes serve it): a
    callable ``(q, qlen, t, tlen, c0)`` of host arrays (LB lanes, LB a
    multiple of the device count) returning host arrays (score (LB,),
    moves (LB, max_steps), si (LB,), tb (LB,)) in lane order."""
    devices = list(mesh.devices.flat)
    kw = dict(W=W, match=match, mismatch=mismatch, gap=gap, x_drop=x_drop,
              max_steps=max_steps)

    def extender(q, qlen, t, tlen, c0):
        per = len(qlen) // len(devices)
        outs = []
        for s, dev in enumerate(devices):
            lanes = slice(s * per, (s + 1) * per)
            if not np.any(qlen[lanes]):
                outs.append(None)   # padding lanes only: each scores 0
                continue
            with _on(dev):
                outs.append(_extend_body(*(
                    torch.from_numpy(np.ascontiguousarray(x[lanes])).to(
                        dev, non_blocking=True)
                    for x in (q, qlen, t, tlen, c0)), **kw))
        empty = (np.zeros(per, np.int32),
                 np.zeros((per, max_steps), np.uint8),
                 np.zeros(per, np.int32), np.zeros(per, np.int32))
        return tuple(np.concatenate([
            empty[j] if o is None else o[j].cpu().numpy() for o in outs])
            for j in range(4))

    return extender


def put_sharded_index(index: BlockIndex, mesh) -> tuple:
    """The block index split over the mesh's block axis: (block_lens,
    block_seq, block_start, sorted_codes, sorted_pos, seed_dirs), each a
    (data, block) object array holding that device's block shard as a
    tensor on it (one copy per device; none where a device already holds
    it); seed_dirs are the shards' :func:`seed_directory`, made on each
    CUDA device (None on the CPU, whose plain route does not read it)."""
    data_par, block_par = mesh.devices.shape
    fields = (index.block_lens, index.block_seq, index.block_start,
              index.sorted_codes, index.sorted_pos)
    per = len(index.block_lens) // block_par
    out = tuple(np.empty(mesh.devices.shape, dtype=object)
                for _ in range(len(fields) + 1))
    for b in range(block_par):
        host = [torch.from_numpy(np.ascontiguousarray(f[b * per:(b + 1) * per]))
                for f in fields]
        for d in range(data_par):
            for o, h in zip(out, host):
                o[d, b] = h.to(mesh.devices[d, b])
            sc = out[3][d, b]
            out[-1][d, b] = (seed_directory(sc, index.k) if sc.is_cuda
                             else None)
    return out
