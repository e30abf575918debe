#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aligngraph2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--genome-mb 1]

Builds the kernels from this checkout (nvcc and g++, in parallel), then
prints one JSON line per phase:

  card    the card, the build seconds and ptxas' register report;
  gate    each CUDA kernel against its plain torch version on the card, on
          planted lanes (B=1024, NQ=8192; W=256 and 512; x_drop 0 and
          250): score, best cell, rows run, directions on rows <= best_i,
          moves, move count and start, all exact; kernel and plain times;
  stage   stages 2, 3 (with the seed rescue) and 4 of the pipeline on a
          synthetic PacBio dataset, on CUDA at full width, with walls,
          reads/s, DP cells and alignments; launch counts are zeroed before
          stage 2 and read after stage 4, and each kernel must have run;
  plain   the first 200 reads through the plain versions on the card:
          their .ref text must equal the kernels';
  profile stage 2 again under torch.profiler: host spans, device time
          by kernel, the card's idle share;
  kernels one entry per CUDA kernel with its launches, error, times and
          bound.

then the card's name and power limit as nvidia-smi prints them and, last,
{"ok": true, "device": {...}}.  Any failure exits nonzero before that
line; so does a machine without CUDA or a directory without the package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published rates: HBM bandwidth, and int32 ALU throughput
# (132 SMs x 64 int32 lanes x 1.98 GHz boost clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DP_OPS_PER_CELL = 20   # serial recurrence: sub, 2 adds, 3 max, 4 selects,
                       # gap chain add+max, best compare+2 selects, pack 2
TB_OPS_PER_STEP = 8    # word index, shift, mask, compare, 2 updates, store
GATE_B, GATE_NQ = 1024, 8192   # the aligner's largest batch, PacBio bucket
REPS = 5
PLAIN_READS = 200


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build_all() -> dict:
    """Build the CUDA kernels and the two host cores, all at once."""
    from aligngraph2_tpu_torch.io import native as io_native
    from aligngraph2_tpu_torch.ops import _cuda, native as ops_native
    from aligngraph2_tpu_torch.utils.nativebuild import lib_path

    def timed(fn):
        t0 = time.perf_counter()
        lib = fn()
        if lib is None:
            raise RuntimeError(f"{fn.__module__} did not build")
        return time.perf_counter() - t0

    jobs = {"banded_static.cu": _cuda.get_lib,
            "fastio.cpp": io_native.get_lib,
            "seedhits.cpp": ops_native.get_lib}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in jobs.items()}
        secs = {k: round(f.result(), 3) for k, f in futs.items()}
    with open(lib_path(_cuda.SRC, _cuda.nvcc_cmd()) + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln
                 or "Compiling entry" in ln]
    return {"build_s": secs, "ptxas": ptxas}


def planted_lanes(rng, B, NQ, W):
    """Random targets with the query planted at the seed diagonal (10%
    substitutions); one lane in eight turns random halfway, so x_drop
    stops it before qlen."""
    import numpy as np
    from aligngraph2_tpu_torch.ops.banded_static import Q_SENTINEL
    q = np.full((B, NQ), Q_SENTINEL, np.uint8)
    qlen = rng.integers(NQ // 2, NQ + 1, B).astype(np.int32)
    t = rng.integers(0, 4, (B, NQ + W)).astype(np.uint8)
    for b in range(B):
        n = int(qlen[b])
        piece = t[b, W // 2:W // 2 + n].copy()
        noise = rng.random(n) < 0.1
        piece[noise] = rng.integers(0, 4, int(noise.sum()))
        if b % 8 == 7:
            piece[n // 2:] = rng.integers(0, 4, n - n // 2)
        q[b, :n] = piece
    return q, t, qlen


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, after one warm-up,
    timed with CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def once_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def dp_bound_ms(res, W, NQ):
    """Least time for the DP of these inputs: the rows each lane ran,
    W cells a row, against the int32 rate; bytes: q and t read for those
    rows, words written for them, per-lane scalars."""
    rows = int(res.rows.sum())
    B = res.rows.numel()
    cells = rows * W
    nbytes = rows + (rows + B * W) + cells // 4 + B * 4 * 5
    ops_ms = cells * DP_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes"), cells


def tb_bound_ms(n, B, max_steps):
    """Least time for the traceback: the 2-bit code of each step read, the
    dense moves written once, per-lane scalars; TB_OPS_PER_STEP a step."""
    steps = int(n.sum())
    nbytes = steps // 4 + B * max_steps + B * 4 * 5
    ops_ms = steps * TB_OPS_PER_STEP / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def gate(args) -> dict:
    """Kernels against their plain versions; returns the timings at the
    main path's shape (W=256, x_drop=250)."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.ops import banded_static as bs

    dev = torch.device("cuda")
    B, NQ = GATE_B, GATE_NQ
    rng = np.random.default_rng(args.seed)
    err = {"dp": 0, "tb": 0}
    timing = {}
    for W in (256, 512):
        q, t, qlen = planted_lanes(rng, B, NQ, W)
        qd, td, qld = (torch.from_numpy(x).to(dev) for x in (q, t, qlen))
        max_steps = 2 * NQ + W
        for x_drop in (0, 250):
            kw = dict(W=W, x_drop=x_drop)

            def run_dp():
                return bs.banded_dp_static(qd, td, qld, **kw)

            res = run_dp()
            tb = bs.traceback_static(res.words, res.best_i, res.best_j,
                                     max_steps=max_steps)
            torch.cuda.synchronize()
            plain_dp_ms, ref = once_ms(
                lambda: bs.banded_dp_static_ref(qd, td, qld, **kw))
            plain_tb_ms, tbr = once_ms(lambda: bs.traceback_static_ref(
                ref.words, ref.best_i, ref.best_j, max_steps=max_steps))
            bad = []
            for name in ("score", "best_i", "best_j", "rows"):
                d = (getattr(res, name) - getattr(ref, name)).abs().max()
                err["dp"] = max(err["dp"], int(d))
                if int(d):
                    bad.append(name)
            rows_ok = (torch.arange(NQ, device=dev)[None, :]
                       < ref.best_i[:, None])
            for s in range(0, B, 64):
                a = bs.unpack_words(res.words[s:s + 64])
                r = bs.unpack_words(ref.words[s:s + 64])
                m = rows_ok[s:s + 64, :, None]
                d = ((a.int() - r.int()).abs() * m).max()
                err["dp"] = max(err["dp"], int(d))
                if int(d):
                    bad.append(f"dirs[{s}:{s + 64}]")
            for name, a, r in zip(("moves", "n", "si", "sj"), tb, tbr):
                d = (a.int() - r.int()).abs().max()
                err["tb"] = max(err["tb"], int(d))
                if int(d):
                    bad.append(name)
            dp_ms = cuda_ms(run_dp, REPS)
            tb_ms = cuda_ms(lambda: bs.traceback_static(
                res.words, res.best_i, res.best_j, max_steps=max_steps),
                REPS)
            dp_b, dp_by, cells = dp_bound_ms(res, W, NQ)
            tb_b, tb_by = tb_bound_ms(tb[1], B, max_steps)
            line = {"phase": "gate", "B": B, "NQ": NQ, "W": W,
                    "x_drop": x_drop, "exact": not bad, "mismatch": bad,
                    "dp_cells": cells,
                    "lanes_stopped_early": int((res.rows < NQ).sum()),
                    "dp_ms": dp_ms, "dp_plain_ms": plain_dp_ms,
                    "dp_bound_ms": dp_b, "dp_bound_by": dp_by,
                    "tb_ms": tb_ms, "tb_plain_ms": plain_tb_ms,
                    "tb_bound_ms": tb_b, "tb_bound_by": tb_by,
                    "tb_moves": int(tb[1].sum())}
            emit(line)
            if bad:
                raise SystemExit(f"gate failed at W={W} x_drop={x_drop}: "
                                 f"{bad}")
            if W == 256 and x_drop == 250:
                timing = dict(dp=(dp_ms, plain_dp_ms, dp_b, dp_by),
                              tb=(tb_ms, plain_tb_ms, tb_b, tb_by))
            del res, tb, ref, tbr
    timing["err"] = err
    return timing


def check_records(alns, qdb, tdb, limit=300):
    """Gapped strings spell the claimed intervals, on both strands."""
    for a in list(alns)[:limit]:
        tseq = tdb.get_str(tdb.seq_id(a.ref_name))
        assert 0 <= a.rb < a.re <= len(tseq), a
        assert a.tstr.replace("-", "") == tseq[a.rb:a.re], a.query_name
        qid = qdb.seq_id(a.query_name)
        qs = qdb.get_str(qid, a.forward)
        lo, hi = ((a.qb, a.qe) if a.forward
                  else (a.qsize - a.qe, a.qsize - a.qb))
        assert a.qstr.replace("-", "") == qs[lo:hi], a.query_name


def slice_run(args) -> dict:
    """Stages 2-4 on CUDA; returns the main path's launch counts."""
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    from aligngraph2_tpu_torch.ops import banded_static as bs
    from tests.synth import make_dataset

    t0 = time.perf_counter()
    ds = make_dataset(seed=args.seed, genome_len=int(args.genome_mb * 1e6),
                      coverage=20, mean_read=9000, read_err=0.13,
                      similar_div=0.01, profile="pacbio")
    reads = SeqDatabase(ds["reads"])
    ctgs = SeqDatabase(ds["contigs"])
    refs = SeqDatabase(ds["similar"])
    cfg = AlignerConfig()
    n_reads = len(reads)
    emit({"phase": "data", "genome_bp": len(ds["genome"]), "reads": n_reads,
          "read_bp": int(reads.lengths.sum()),
          "longest_read": int(reads.lengths.max()), "contigs": len(ctgs),
          "setup_s": time.perf_counter() - t0})

    bs.banded_dp_static.launches = 0
    bs.traceback_static.launches = 0

    def stage(name, work, n_queries):
        t0 = time.perf_counter()
        alns, aligners = work()
        wall = time.perf_counter() - t0
        emit({"phase": "stage", "stage": name, "wall_s": wall,
              "queries": n_queries, "queries_per_s": n_queries / wall,
              "alignments": len(alns),
              "aligned_queries": len({a.query_name for a in alns}),
              "dp_cells": sum(a.dp_cells for a in aligners)})
        return alns

    def read_to_ctg():
        al = LongReadAligner(ctgs, cfg)
        return al.align_reads(reads), [al]

    def read_to_ref():
        p1 = LongReadAligner(refs, dataclasses.replace(
            cfg, seed_k=cfg.seed_k, seed_k_auto=False))
        r2r = p1.align_reads(reads)
        got = {a.query_name for a in r2r}
        miss = [r for r in range(n_reads) if reads.names[r] not in got]
        used = [p1]
        if miss:
            p2 = LongReadAligner(refs, dataclasses.replace(
                cfg, seed_k=cfg.ref_seed_k, seed_k_auto=False))
            for a in p2.align_reads(reads, ids=miss):
                r2r.append(a)
            r2r.sort_by_score()
            used.append(p2)
        emit({"phase": "rescue", "unaligned_after_pass1": len(miss)})
        return r2r, used

    def ctg_to_ref():
        al = LongReadAligner(refs, cfg)
        return al.align_chunked(ctgs), [al]

    r2c = stage("read_to_ctg", read_to_ctg, n_reads)
    r2r = stage("read_to_ref", read_to_ref, n_reads)
    c2r = stage("ctg_to_ref", ctg_to_ref, len(ctgs))
    launches = {"banded_dp_static": bs.banded_dp_static.launches,
                "traceback_static": bs.traceback_static.launches}
    emit({"phase": "launches", **launches})
    if not all(launches.values()):
        raise SystemExit(f"a kernel of the main path never ran: {launches}")
    if len({a.query_name for a in r2c}) < 0.8 * n_reads:
        raise SystemExit("fewer than 80% of reads aligned to the contigs")
    if len({a.query_name for a in c2r}) != len(ctgs):
        raise SystemExit("a contig did not align to the similar genome")
    check_records(r2c, reads, ctgs)
    check_records(r2r, reads, refs)
    check_records(c2r, ctgs, refs)

    # the first reads through the kernels and through the plain versions
    ids = range(min(PLAIN_READS, n_reads))
    t0 = time.perf_counter()
    kern = LongReadAligner(ctgs, cfg).align_reads(reads, ids=ids)
    t1 = time.perf_counter()
    plain = LongReadAligner(ctgs, cfg, plain=True).align_reads(reads,
                                                               ids=ids)
    t2 = time.perf_counter()
    same = kern.to_ref_text() == plain.to_ref_text()
    emit({"phase": "plain", "reads": len(ids), "alignments": len(kern),
          "ref_text_equal": same, "kernel_s": t1 - t0, "plain_s": t2 - t1})
    if not same or not len(kern):
        raise SystemExit("kernel and plain .ref text differ")
    profile_stage(lambda: LongReadAligner(ctgs, cfg).align_reads(reads))
    return launches


def profile_stage(work) -> None:
    """Stage 2 once more under torch.profiler: the aligner's host spans,
    device time by kernel and the card's idle share of the wall.  The
    profiler's own cost is in this wall, so it reads longer than the
    stage line's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, device = {}, {}
    for e in prof.key_averages():
        on_card = e.device_type == DeviceType.CUDA
        if e.key.startswith("align."):
            # a span appears twice: on the host, and on the card's
            # timeline around the work it queued
            if not on_card:
                spans[e.key] = e.cpu_time_total / 1e3
        elif on_card:   # kernels, copies and fills on the card
            device[e.key[:80]] = e.self_device_time_total / 1e3
    busy = sum(device.values())
    emit({"phase": "profile", "stage": "read_to_ctg", "wall_ms": wall_ms,
          "host_span_ms": spans, "device_ms": device,
          "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-mb", type=float, default=1.0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import aligngraph2_tpu_torch  # noqa: F401
        import tests.synth  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    card = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          **build_all()})
    timing = gate(args)
    launches = slice_run(args)
    kernels = []
    for name, key, replaces in (
            ("banded_dp_static", "dp",
             "aligngraph2_tpu/ops/banded_pallas.py:54"),
            ("traceback_static", "tb",
             "aligngraph2_tpu/ops/banded_pallas.py:375")):
        ms, plain_ms, bound, by = timing[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "aligngraph2_tpu_torch/csrc/banded_static.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": float(timing["err"][key]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
