"""High-level seed-extend long-read aligner, on one device.

Counterpart of ``aligngraph2_tpu/align/aligner.py`` (``LongReadAligner``,
``align_chunked``), the single-device path: host seeding in C++
(``ops/seedextend.py``), banded extension on the device, 3-line ``.ref``
records.  It stands in for the reference's external aligners in four
stages: reads -> contigs, reads -> similar genome, contigs -> genome
(through ``align_chunked``) and reads -> new backbones.

The band follows the device, as the JAX package's ``use_pallas`` does:

  * ``device="cuda"`` (the default): the static band of
    ``ops/banded_static.py`` through its CUDA kernels, batches of one
    length bucket software-pipelined — while the card runs batch i, the
    host prepares batch i+1 into pinned buffers; copies are
    ``non_blocking`` and no call in ``_dispatch`` waits for the card;
  * ``device="cpu"``: the adaptive band of ``ops/banded_dp.py``, so the
    records equal the JAX package's on the CPU byte for byte;
  * ``band="static"`` on the CPU, or ``plain=True`` on either device: the
    static band through the plain torch versions of the kernels (the
    reference the card is held against), and the long reads' adaptive
    band through its plain versions too.

Under the static band, buckets past 65536 (reads of 65,537 bp up to
``max_read_len``) take the adaptive band on the aligner's device, as the
JAX package sends them to its adaptive scan (``pallas_ok`` there): the
static pipeline is drained first, and the batch is sized as an adaptive
one.  On a card that band runs its own CUDA kernels
(``csrc/banded_adaptive.cu``), or with ``plain=True`` its plain torch
versions; such reads are rare (about 5e-5 of PacBio reads).

With no CUDA device the default raises; it does not fall back to the CPU.
A kernel that fails to build or launch raises too.  While a profiler
records, the host phases run under spans (``utils/timing.py``, which
lists them: ``align.index``, ``align.seed``, ``align.prep``,
``align.dispatch``, ``align.finish`` and their parts), so a profiler
trace splits a stage's wall between them and the card.

With ``mesh`` (``parallel/mesh.py``) the aligner takes the JAX package's
mesh path instead: device seeding over a block index split on the mesh's
``block`` axis, reads split on its ``data`` axis, host compaction of the
live lanes, and the adaptive band on lanes split over every device
(``parallel/sharded.py``).  Its records equal the JAX mesh path's for any
mesh shape.  A failure there raises: unlike the JAX package, it does not
fall back to the single-device path.

Left out: the pallas -> scan degrade chain is gone (no path catches a
kernel error); batches are not padded to the bucket's full size, since
the kernels take runtime shapes.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Sequence

import numpy as np
import torch

from ..config import AlignerConfig
from ..io.seqdb import SeqDatabase, decode_seq, revcomp_codes
from ..ops.banded_dp import (banded_align, banded_align_ref, decode_strings,
                             moves_to_strings, traceback, traceback_ref)
from ..ops.banded_static import (Q_SENTINEL, banded_dp_static,
                                 banded_dp_static_ref,
                                 standard_frame_windows, traceback_static,
                                 traceback_static_ref)
from ..ops.seedextend import (Candidate, SeedIndex, effective_seed_k,
                              find_candidates_batch)
from ..utils.timing import Progress, count, span
from .records import Alignment, AlignmentSet

logger = logging.getLogger("aligngraph2_tpu_torch.align")

# the largest bucket the static band takes; longer reads take the adaptive
# band, as in the JAX package
STATIC_MAX_NQ = 65536


def _bucket(n: int, lo: int = 512) -> int:
    """Length bucket of a batch: jobs of one bucket share a batch, padded
    to its length.  The 10240/12288/16384 rungs keep PacBio-length reads
    (~9 kb mean) from padding to 32768."""
    for b in (512, 2048, 8192, 10240, 12288, 16384, 32768):
        if n <= b:
            return b
    b = 32768
    while b < n:
        b <<= 1
    return b


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev}: the aligner runs on cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "to run the aligner on the CPU")
    return dev


class LongReadAligner:
    """Seed-extend aligner over ``target_db``: host seeding, banded
    extension on ``device`` (see the module docstring for ``band`` and
    ``plain``); with ``mesh``, device seeding and the adaptive band on the
    mesh's devices, which stand in for ``device``.  After
    :meth:`align_reads`, ``dp_cells`` holds the static band's DP cells
    computed so far (rows run x W)."""

    def __init__(self, target_db: SeqDatabase, cfg: AlignerConfig,
                 device=None, band: str | None = None, plain: bool = False,
                 progress: bool = False, mesh=None,
                 checkpoint_path: str | None = None,
                 checkpoint_flush_s: float = 300.0):
        if mesh is not None:
            if band == "static" or plain:
                raise ValueError("the mesh path runs the adaptive band")
            device, band = mesh.devices.flat[0], "adaptive"
        self.device = resolve_device(device)
        if band is None:
            band = "static" if self.device.type == "cuda" else "adaptive"
        if band not in ("static", "adaptive"):
            raise ValueError(f"band={band!r}: 'static' or 'adaptive'")
        if plain and band != "static":
            raise ValueError("plain=True runs the static band")
        self.band = band
        self.plain = plain
        self.db = target_db
        # auto-scale seed k with target size (flat noise-hit rate; see
        # ops/seedextend.effective_seed_k)
        k_eff = effective_seed_k(cfg, target_db)
        if k_eff != cfg.seed_k:
            logger.info("seed_k auto-scaled %d -> %d for a %.1f Mb "
                        "target", cfg.seed_k, k_eff,
                        target_db.lengths.sum() / 1e6)
            cfg = dataclasses.replace(cfg, seed_k=k_eff)
        self.cfg = cfg
        self.mesh = mesh
        self.checkpoint_path = checkpoint_path
        self.checkpoint_flush_s = checkpoint_flush_s
        if mesh is None:
            with span("align.index"):
                self.index = SeedIndex(target_db, cfg.seed_k,
                                       stride=cfg.seed_stride)
        else:
            self._block_index = None   # built on the first align_reads
            self._dev_index = None
            self._seeders = {}
            self._extenders = {}
        self.progress = progress
        self.dp_cells = 0
        self.n_dedup_suppressed = 0
        self.n_skipped_long = 0

    # ---------------- checkpointing ----------------

    def _make_checkpoint(self, read_db, ids, kind: str,
                         out: AlignmentSet, best_per_read) -> tuple:
        """(checkpoint, resume cursor): intra-stage resume for long
        alignment stages (align/checkpoint.py).  Preloads already-emitted
        alignments into the running set so the duplicate filter and
        per-read best table see the same history as an uninterrupted
        run."""
        if not self.checkpoint_path:
            return None, 0
        from .checkpoint import AlignCheckpoint, stage_token
        token = stage_token(self.cfg, self.db, read_db,
                            list(ids) if ids is not None else None) \
            + "/" + kind
        ck = AlignCheckpoint(self.checkpoint_path, token,
                             self.checkpoint_flush_s)
        cursor, pre = ck.resume()
        for a in pre:
            out.append(a)
            if a.score > best_per_read.get(a.query_name, 0):
                best_per_read[a.query_name] = a.score
        return ck, cursor

    # ---------------- extension ----------------

    def align_reads(self, read_db: SeqDatabase,
                    ids: Sequence[int] | None = None) -> AlignmentSet:
        cfg = self.cfg
        W = cfg.band_width
        if ids is None:
            ids = range(len(read_db))
        # ultra-long outliers would explode the padded DP stream; skip them
        ids = list(ids)
        n_before = len(ids)
        ids = [r for r in ids if read_db.size(r) <= cfg.max_read_len]
        self.n_skipped_long = n_before - len(ids)
        if self.n_skipped_long:
            logger.warning(
                "skipping %d read(s) longer than max_read_len=%d "
                "(raise AlignerConfig.max_read_len to align them)",
                self.n_skipped_long, cfg.max_read_len)
        if self.mesh is not None:
            return self._align_reads_sharded(read_db, ids)

        # phase 1: batched seeding (host)
        with span("align.seed"):
            cand_map = find_candidates_batch(
                self.index, read_db, list(ids),
                bin_w=max(cfg.band_width // 2, 32),
                max_candidates=cfg.max_candidates,
                min_hits=cfg.min_block_hits, alpha=cfg.alpha,
                beta=cfg.beta, prune=cfg.prune_ratio)
        jobs = []  # (rid, cand, codes_aligned_strand)
        for rid, cands in cand_map.items():
            if not cands:
                continue
            codes_f = read_db.get_codes(rid)
            for cand in cands:
                codes = codes_f if cand.forward else revcomp_codes(codes_f)
                jobs.append((rid, cand, codes))

        # phase 2: banded extension, batched by length bucket
        jobs.sort(key=lambda j: len(j[2]))
        out = AlignmentSet()
        best_per_read: dict[str, int] = {}
        ck, cursor = self._make_checkpoint(read_db, ids, "single", out,
                                           best_per_read)
        watermark = len(out)
        bar = Progress(len(jobs), enabled=self.progress)
        start = min(cursor, len(jobs))
        bar.update(start)
        batches = self._plan(jobs, start)

        def done(n_jobs: int, consumed: int) -> None:
            nonlocal watermark
            bar.update(n_jobs)
            if ck is not None and ck.should_flush():
                ck.flush(out.alignments[watermark:], consumed)
                watermark = len(out)

        def drain(pending) -> None:
            with span("align.finish"):
                self._finish(read_db, *pending[:2], out, best_per_read)
            done(len(pending[0][0]), pending[2])

        # software pipeline of the static batches: dispatch batch i+1
        # before draining batch i; an adaptive batch drains it first
        pending = None
        for NQ, static, batch, end_i in batches:
            if not static:
                if pending is not None:
                    drain(pending)
                    pending = None
                self._extend_batch(read_db, batch, NQ, NQ + 2 * W, out,
                                   best_per_read)
                done(len(batch), end_i)
                continue
            with span("align.prep"):
                prep = self._prep(batch, NQ)
            with span("align.dispatch"):
                handles = self._dispatch(prep)
            if pending is not None:
                drain(pending)
            pending = (prep, handles, end_i)
        if pending is not None:
            drain(pending)
        if ck is not None:
            ck.close()

        return self._delta_filter(out, best_per_read)

    def _delta_filter(self, out: AlignmentSet, best_per_read) -> AlignmentSet:
        """Drop alignments scoring < delta * their read's best (recovered
        mecat2ref+ '-y delta' semantics, see seedextend.py); sort by
        score."""
        kept = [a for a in out
                if a.score >= self.cfg.delta * best_per_read.get(
                    a.query_name, a.score)]
        if self.n_dedup_suppressed:
            logger.info("suppressed %d duplicate alignment(s) "
                        "(last-%d-record window)", self.n_dedup_suppressed,
                        8)
        res = AlignmentSet(kept)
        res.sort_by_score()
        count("align.records", len(res))
        return res

    def align_chunked(self, query_db: SeqDatabase) -> AlignmentSet:
        """Contig -> target alignment through fixed-size pseudo-reads: see
        the module-level :func:`align_chunked`."""
        chunk = self.cfg.chunk_len
        pieces = []
        for cid in range(len(query_db)):
            codes = query_db.get_codes(cid)
            n_parts = (len(codes) + chunk - 1) // chunk
            for p in range(n_parts):
                pieces.append((f"{cid}_{p}",
                               codes[p * chunk:min(len(codes),
                                                   (p + 1) * chunk)]))
        piece_db = SeqDatabase((nm, decode_seq(c)) for nm, c in pieces)
        out = AlignmentSet()
        for a in self.align_reads(piece_db):
            cid_s, p_s = a.query_name.split("_")
            cid, p = int(cid_s), int(p_s)
            offset = p * chunk
            out.append(Alignment(
                query_name=query_db.names[cid], ref_name=a.ref_name,
                forward=a.forward, score=a.score,
                qb=a.qb + offset, qe=a.qe + offset,
                qsize=query_db.size(cid),
                rb=a.rb, re=a.re, rsize=a.rsize,
                qstr=a.qstr, tstr=a.tstr))
        return out

    def _plan(self, jobs, start: int = 0) -> list:
        """Batches of ``jobs[start:]`` (sorted by length): one length
        bucket each, as (NQ, static, batch, end index).  ``static`` says
        the batch takes the static band: the aligner's band is static and
        NQ <= STATIC_MAX_NQ (``pallas_ok`` of the JAX package)."""
        batches = []
        i = start
        while i < len(jobs):
            NQ = _bucket(len(jobs[i][2]))
            static = self.band == "static" and NQ <= STATIC_MAX_NQ
            B = self._batch_size(NQ, static)
            batch = []
            while i < len(jobs) and len(batch) < B \
                    and _bucket(len(jobs[i][2])) == NQ:
                batch.append(jobs[i])
                i += 1
            batches.append((NQ, static, batch, i))
        return batches

    def _batch_size(self, NQ: int, static: bool) -> int:
        if static:
            # bound the direction words to ~1.5 GB per batch, with two
            # batches in flight
            W = max(self.cfg.band_width, 256)
            b = (3 << 29) // (NQ * W)
            return int(np.clip(b // 128 * 128, 128, 1024))
        return max(1, min(64, (64 << 20) // (NQ * self.cfg.band_width)))

    def _emit(self, read_db, rid, cand, codes, score, qstr, tstr,
              qb, qe, rb, re, out: AlignmentSet, best_per_read) -> None:
        cfg = self.cfg
        if qe - qb < cfg.min_aln_len:
            return
        qa = np.frombuffer(qstr.encode(), np.uint8)
        ta = np.frombuffer(tstr.encode(), np.uint8)
        matches = int(np.count_nonzero(qa == ta))
        if matches < cfg.min_identity * len(qstr):
            return
        n = len(codes)
        if cand.forward:
            qb_f, qe_f = qb, qe
        else:
            qb_f, qe_f = n - qe, n - qb
        a = Alignment(
            query_name=read_db.names[rid],
            ref_name=self.db.names[cand.tid],
            forward=cand.forward, score=score,
            qb=qb_f, qe=qe_f, qsize=n,
            rb=rb, re=re, rsize=self.db.size(cand.tid),
            qstr=qstr, tstr=tstr)
        if self._is_duplicate(out, a):
            self.n_dedup_suppressed += 1
            return
        out.append(a)
        if score > best_per_read.get(a.query_name, 0):
            best_per_read[a.query_name] = score

    # ---------------- static band: prep -> dispatch -> finish ----------

    def _prep(self, batch, NQ):
        """Host stage: pad queries and gather standard-frame windows, in
        pinned memory when the batch goes to the card."""
        W = max(self.cfg.band_width, 256)
        B = len(batch)
        q = np.full((B, NQ), Q_SENTINEL, np.uint8)
        qlen = np.zeros(B, np.int32)
        for b, (rid, cand, codes) in enumerate(batch):
            q[b, :len(codes)] = codes
            qlen[b] = len(codes)
        t, starts = standard_frame_windows(
            [self.db.get_codes(cand.tid) for _, cand, _ in batch],
            [cand.diag for _, cand, _ in batch], NQ, W)
        host = [torch.from_numpy(x) for x in (q, t, qlen)]
        if self.device.type == "cuda":
            host = [x.pin_memory() for x in host]
        return batch, NQ, W, host, t, starts

    def _dispatch(self, prep):
        """Device stage: DP and traceback, then copies back to pinned host
        buffers, all queued on the current stream.  Nothing here waits for
        the card; returns (host buffers, completion event)."""
        batch, NQ, W, host, t, starts = prep
        cfg = self.cfg
        dev = self.device
        q, tt, qlen = (x.to(dev, non_blocking=True) for x in host)
        dp, tb = ((banded_dp_static_ref, traceback_static_ref) if self.plain
                  else (banded_dp_static, traceback_static))
        res = dp(q, tt, qlen, W=W, match=cfg.match_score,
                 mismatch=cfg.mismatch_score, gap=cfg.gap_score,
                 x_drop=cfg.x_drop)
        moves, _, si, sj = tb(res.words, res.best_i, res.best_j,
                              max_steps=2 * NQ + W)
        outs = (res.score, si, sj, res.rows, moves)
        if dev.type != "cuda":
            return outs, None
        back = []
        for x in outs:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x, non_blocking=True)
            back.append(h)
        ev = torch.cuda.Event()
        ev.record()
        return back, ev

    def _finish(self, read_db: SeqDatabase, prep, handles,
                out: AlignmentSet, best_per_read) -> None:
        """Host stage: wait for the batch, rebuild strings, emit records
        (the strings of every job first, then the records in job order)."""
        batch, NQ, W, host, t, starts = prep
        back, ev = handles
        if ev is not None:
            with span("align.finish.wait"):
                ev.synchronize()
        scores, si, sj, rows, moves = (x.numpy() for x in back)
        self.dp_cells += int(rows.astype(np.int64).sum()) * W
        with span("align.finish.strings"):
            found = []
            for b, (rid, cand, codes) in enumerate(batch):
                score = int(scores[b])
                if score <= 0:
                    continue
                qb = int(si[b])
                tb = int(si[b] + sj[b])   # standard frame: p = i + j
                win = np.minimum(t[b], 3)  # sentinel-safe decode
                qstr, tstr, qe, te = moves_to_strings(moves[b], codes, qb,
                                                      tb, win)
                rb = int(starts[b] + tb)
                re = int(starts[b] + te)
                if rb < 0 or re > self.db.size(cand.tid):
                    continue  # degenerate path through sentinel padding
                found.append((rid, cand, codes, score, qstr, tstr, qb, qe,
                              rb, re))
        with span("align.finish.emit"):
            for f in found:
                self._emit(read_db, *f, out, best_per_read)

    # ---------------- adaptive band ----------------

    def _extend_batch(self, read_db: SeqDatabase, batch, NQ, NT,
                      out: AlignmentSet, best_per_read) -> None:
        cfg = self.cfg
        W = cfg.band_width
        B = len(batch)
        q = np.zeros((B, NQ), np.uint8)
        t = np.zeros((B, NT), np.uint8)
        qlen = np.zeros(B, np.int32)
        tlen = np.zeros(B, np.int32)
        c0 = np.zeros(B, np.int32)
        ws_arr = np.zeros(B, np.int64)
        for b, (rid, cand, codes) in enumerate(batch):
            n = len(codes)
            q[b, :n] = codes
            qlen[b] = n
            tcodes = self.db.get_codes(cand.tid)
            ws = max(0, cand.diag - W)
            win = tcodes[ws:ws + NT]
            t[b, :len(win)] = win
            tlen[b] = len(win)
            c0[b] = cand.diag - ws
            ws_arr[b] = ws

        dev = self.device
        dp, tb = ((banded_align_ref, traceback_ref) if self.plain
                  else (banded_align, traceback))
        res = dp(*(torch.from_numpy(x).to(dev)
                   for x in (q, qlen, t, tlen, c0)), W=W,
                 match=cfg.match_score, mismatch=cfg.mismatch_score,
                 gap=cfg.gap_score, x_drop=cfg.x_drop)
        moves, _, si, sj = tb(res.dirs, res.centers, res.best_i, res.best_j,
                              max_steps=NQ + NT)
        moves, centers, scores, si, sj = (
            x.cpu().numpy() for x in (moves, res.centers, res.score, si, sj))

        for b, (rid, cand, codes) in enumerate(batch):
            score = int(scores[b])
            if score <= 0:
                continue
            qb = int(si[b])
            tb = int(si[b] + centers[b][si[b]] - W // 2 + sj[b])
            tcodes = self.db.get_codes(cand.tid)
            win = tcodes[ws_arr[b]:ws_arr[b] + NT]
            qstr, tstr, qe, te = moves_to_strings(moves[b], codes, qb, tb,
                                                  win)
            rb = int(ws_arr[b] + tb)
            re = int(ws_arr[b] + te)
            self._emit(read_db, rid, cand, codes, score, qstr, tstr,
                       qb, qe, rb, re, out, best_per_read)

    # ---------------- mesh path ----------------

    def _ensure_sharded_index(self) -> None:
        from ..parallel.sharded import (build_block_index, mesh_block_len,
                                        put_sharded_index)
        if self._block_index is not None:
            return
        cfg = self.cfg
        longest = int(self.db.lengths.max()) if len(self.db) else 1
        BL = mesh_block_len(longest, cfg.block_size, cfg.band_width)
        with span("align.index"):
            self._block_index = build_block_index(
                self.db, cfg.seed_k, BL,
                pad_blocks_to=self.mesh.devices.shape[1])
            self._dev_index = put_sharded_index(self._block_index, self.mesh)

    def _get_seeder(self, NQ: int):
        if NQ not in self._seeders:
            from ..parallel.sharded import make_sharded_seeder
            cfg = self.cfg
            self._seeders[NQ] = make_sharded_seeder(
                self.mesh, k=cfg.seed_k, BL=self._block_index.block_len,
                bin_w=max(cfg.band_width // 2, 32),
                min_hits=cfg.min_block_hits, alpha=cfg.alpha,
                beta=cfg.beta, K=cfg.max_candidates, prune=cfg.prune_ratio)
        return self._seeders[NQ]

    def _get_extender(self, NQ: int, NT: int):
        if NQ not in self._extenders:
            from ..parallel.sharded import make_sharded_extender
            cfg = self.cfg
            self._extenders[NQ] = make_sharded_extender(
                self.mesh, W=cfg.band_width, match=cfg.match_score,
                mismatch=cfg.mismatch_score, gap=cfg.gap_score,
                x_drop=cfg.x_drop, max_steps=NQ + NT)
        return self._extenders[NQ]

    def _align_reads_sharded(self, read_db: SeqDatabase,
                             ids: Sequence[int]) -> AlignmentSet:
        """Mesh path of align_reads: device seeding over the block-sharded
        index, host lane compaction, extension on every device.  Output
        is bit-identical for any mesh shape."""
        cfg = self.cfg
        W = cfg.band_width
        K = cfg.max_candidates
        self._ensure_sharded_index()
        idx = self._block_index
        data_par = self.mesh.devices.shape[0]
        n_dev = self.mesh.size

        buckets: dict[int, list[int]] = {}
        for rid in ids:
            buckets.setdefault(_bucket(read_db.size(rid)), []).append(rid)

        out = AlignmentSet()
        best_per_read: dict[str, int] = {}
        # chunk partitioning depends on the mesh shape, so the resume
        # token must too (a resume on a different mesh restarts cleanly)
        mesh_kind = "mesh" + "x".join(str(int(s))
                                      for s in self.mesh.shape.values())
        ck, ck_cursor = self._make_checkpoint(read_db, ids, mesh_kind, out,
                                              best_per_read)
        watermark = len(out)
        consumed = 0   # reads consumed, in deterministic bucket order
        bar = Progress(len(ids), enabled=self.progress)
        for NQ in sorted(buckets):
            NT = NQ + 2 * W
            per_dev = max(1, min(64, (64 << 20) // (NQ * W)))
            B = data_par * per_dev
            lane_B = n_dev * per_dev
            seeder = self._get_seeder(NQ)
            extender = self._get_extender(NQ, NT)
            idsb = buckets[NQ]
            for s in range(0, len(idsb), B):
                chunk = idsb[s:s + B]
                if consumed + len(chunk) <= ck_cursor:
                    consumed += len(chunk)   # resumed past this chunk
                    bar.update(len(chunk))
                    continue
                rows = chunk + [-1] * (B - len(chunk))
                with span("align.pack"):
                    q_fwd = np.zeros((B, NQ), np.uint8)
                    q_rev = np.zeros((B, NQ), np.uint8)
                    lens = np.zeros(B, np.int32)
                    for r, rid in enumerate(chunk):
                        cf = read_db.get_codes(rid)
                        q_fwd[r, :len(cf)] = cf
                        q_rev[r, :len(cf)] = revcomp_codes(cf)
                        lens[r] = len(cf)
                with span("align.seed"):
                    sel, c_block, c_strand, c_diag, c_cnt, c_score = seeder(
                        q_fwd, q_rev, lens, *self._dev_index)

                # host lane compaction: live (read, candidate) pairs only
                with span("align.compact"):
                    lanes = []  # (row, k, tid, bstart, ws, c0)
                    for r in range(len(chunk)):
                        for kk in range(K):
                            if not sel[r, kk]:
                                continue
                            blk = int(c_block[r, kk])
                            diag = int(c_diag[r, kk])
                            tid = int(idx.block_seq[blk])
                            bstart = int(idx.block_start[blk])
                            ws = max(0, diag - W)
                            if min(self.db.size(tid) - (bstart + ws),
                                   NT) <= 0:
                                continue
                            lanes.append((r, kk, tid, bstart, ws, diag - ws))
                for ls in range(0, len(lanes), lane_B):
                    self._extend_lanes(read_db, extender, lanes[ls:ls + lane_B],
                                       lane_B, NQ, NT, rows, q_fwd, q_rev,
                                       lens, c_strand, c_diag, c_cnt, c_score,
                                       out, best_per_read)
                bar.update(len(chunk))
                consumed += len(chunk)
                if ck is not None and ck.should_flush():
                    ck.flush(out.alignments[watermark:], consumed)
                    watermark = len(out)
        if ck is not None:
            ck.close()
        return self._delta_filter(out, best_per_read)

    def _extend_lanes(self, read_db, extender, lchunk, LB, NQ, NT, rows,
                      q_fwd, q_rev, lens, c_strand, c_diag, c_cnt, c_score,
                      out: AlignmentSet, best_per_read) -> None:
        """One chunk of live lanes through the sharded extender, padded to
        LB lanes; emits its records."""
        with span("align.prep"):
            q = np.zeros((LB, NQ), np.uint8)
            qlen = np.zeros(LB, np.int32)
            t = np.zeros((LB, NT), np.uint8)
            tl = np.zeros(LB, np.int32)
            c0 = np.zeros(LB, np.int32)
            for li, (r, kk, tid, bstart, ws, c0v) in enumerate(lchunk):
                q[li] = q_fwd[r] if c_strand[r, kk] else q_rev[r]
                qlen[li] = lens[r]
                win = self.db.get_codes(tid)[bstart + ws:bstart + ws + NT]
                t[li, :len(win)] = win
                tl[li] = len(win)
                c0[li] = c0v
        count("extend.lanes", len(lchunk))
        with span("align.dispatch"):
            ext = extender(q, qlen, t, tl, c0)
        count("extend.card_strings",
              np.count_nonzero(ext.card[:len(lchunk)]))
        with span("align.finish"):
            # the strings of every lane, then the records in lane order:
            # only _emit reads out and best_per_read.  A card made its
            # lanes' strings; a CPU lane's come from its moves here.
            with span("align.finish.strings"):
                found = []
                for li, (r, kk, tid, bstart, ws, c0v) in enumerate(lchunk):
                    score = int(ext.score[li])
                    if score <= 0:
                        continue
                    forward = bool(c_strand[r, kk])
                    codes = (q_fwd[r] if forward else q_rev[r])[:lens[r]]
                    qb = int(ext.si[li])
                    tb = int(ext.tb[li])
                    if ext.card[li]:
                        qstr, tstr, qe, te = decode_strings(ext.strings[li])
                    else:
                        win = self.db.get_codes(tid)[bstart + ws:
                                                     bstart + ws + NT]
                        qstr, tstr, qe, te = moves_to_strings(
                            ext.moves[li], codes, qb, tb, win)
                    cand = Candidate(tid=tid, forward=forward,
                                     diag=bstart + int(c_diag[r, kk]),
                                     hits=int(c_cnt[r, kk]),
                                     score=float(c_score[r, kk]))
                    found.append((rows[r], cand, codes, score, qstr, tstr,
                                  qb, qe, bstart + ws + tb, bstart + ws + te))
            with span("align.finish.emit"):
                for f in found:
                    self._emit(read_db, *f, out, best_per_read)

    @staticmethod
    def _is_duplicate(out: AlignmentSet, a: Alignment) -> bool:
        """Adjacent seeding candidates can converge to the same alignment
        after band drift; keep the first (higher-ranked) one."""
        for other in out.alignments[-8:]:
            if (other.query_name == a.query_name
                    and other.ref_name == a.ref_name
                    and other.forward == a.forward
                    and min(other.re, a.re) - max(other.rb, a.rb)
                    > 0.5 * (a.re - a.rb)):
                return True
        return False


def align_chunked(target_db: SeqDatabase, query_db: SeqDatabase,
                  cfg: AlignerConfig, progress: bool = False,
                  checkpoint_path: str | None = None, device=None,
                  band: str | None = None, plain: bool = False, mesh=None
                  ) -> AlignmentSet:
    """Contig->reference alignment via fixed-size pseudo-reads.

    Mirrors script/long2ref.py of the reference: chunk each contig into
    ``chunk_len`` pieces, align the pieces, then rewrite coordinates back
    to whole-contig space.  The emitted records use the 10-field header
    the reference's MummerAlignDatabaseV2 consumes.
    """
    return LongReadAligner(target_db, cfg, device=device, band=band,
                           plain=plain, progress=progress, mesh=mesh,
                           checkpoint_path=checkpoint_path
                           ).align_chunked(query_db)
