#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aligngraph2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--genome-mb 1]

Builds the kernels and the five host cores from this checkout (nvcc and
g++, in parallel), then prints one JSON line per phase:

  card    the card, the build seconds and ptxas' register report; any
          kernel or host core that fails to build fails the run;
  gate    each CUDA kernel against its plain torch version on the card, on
          planted lanes (B=1024, NQ=8192; W=256 and 512; x_drop 0 and
          250; the aligner's batch for the 16384 bucket, B=384, W=256,
          x_drop 250; and W=1024 on B=256, NQ=4096): score, best cell,
          rows run, directions on rows <= best_i, moves, move count and
          start, all exact; the traceback also on random direction words,
          whose walks hit both band edges; kernel times, plain times,
          bounds and registers;
  stage   stages 2, 3 (with the seed rescue) and 4 of the pipeline on a
          synthetic PacBio dataset, on CUDA at full width, with walls,
          reads/s, DP cells and alignments; launch counts are zeroed before
          stage 2 and read after stage 4, and each kernel must have run;
  plain   the first 200 reads through the plain versions on the card:
          their .ref text must equal the kernels';
  long_read one read just past the 65536 bucket through the aligner on
          CUDA, where it takes the adaptive band as in the JAX package
          (no static-band launch), and on the CPU in a child process
          started with the plain phase: the .ref text must be equal;
          both walls;
  profile stage 2 again under torch.profiler: host spans, device time
          by kernel, the card's idle share;
  pipeline the whole eight-stage pipeline through run_pipeline on CUDA,
          with the config the CLI builds from its default flags, on a
          5 Mb PacBio dataset (bench_e2e.py's recipe): whole wall,
          reads/s, stage walls and RSS, stage 6's ingest and merge
          seconds (the rest of it is graph set-up, subsets and
          traversal), solid k-mers, groups, chains, consumed contigs,
          and each kernel's launches in stages 2, 3, 4 and 7 (each must
          be nonzero); at least one chain, a longest output longer than
          the longest contig, and identity above 0.85 against the truth
          genome;
  cli     ``python -m aligngraph2_tpu_torch.cli`` as a subprocess on the
          card, flags only, on a small dataset, and the same inputs run
          in-process through the plain versions: the five output files
          must be byte-identical;
  kernels one entry per CUDA kernel with its launches in the pipeline
          phase, error, times and bound.

then the card's name and power limit as nvidia-smi prints them and, last,
{"ok": true, "device": {...}}.  Any failure exits nonzero before that
line; so does a machine without CUDA or a directory without the package.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import re
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
# (B, NQ, W, x_drop) of the gate; the kernels line reads the second
GATE = ((GATE_B, GATE_NQ, 256, 0), (GATE_B, GATE_NQ, 256, 250),
        (GATE_B, GATE_NQ, 512, 0), (GATE_B, GATE_NQ, 512, 250),
        (384, 16384, 256, 250),   # the aligner's batch for the 16384 bucket
        (256, 4096, 1024, 250))   # the widest band the kernels take
LONG_READ_BP = 66000           # past the 65536 bucket
REPS = 5
PLAIN_READS = 200
# the pipeline phase's dataset: bench_e2e.py's 5 Mb PacBio recipe
PIPELINE_DATA = dict(genome_len=5_000_000, coverage=20, mean_read=9000,
                     read_err=0.13, similar_div=0.01, n_contigs=20,
                     contig_gap=2000, profile="pacbio")
# the cli phase's dataset and flags: the legacy 6 kb dataset of
# tests/test_pipeline.py at 20 kb in four contigs (which chain at the
# default seed), reads ~1 kb so the plain versions take short buckets;
# k = 12 keeps the solid set at 4^12 codes
CLI_DATA = dict(genome_len=20_000, coverage=14, mean_read=1000,
                read_err=0.02, n_contigs=4, contig_gap=350)
CLI_FLAGS = ["-k", "12"]
OUTPUTS = ("final.fasta", "remainder.fasta", "exclude.fasta", "add.fasta",
           "connect_info.txt")
# each aligner stage's opening message in run_pipeline's log, and its key
# in the run's stage_s
ALIGNER_STAGES = {"Read to Contig...": "read_to_ctg",
                  "Read to Ref...": "read_to_ref",
                  "Contig to Ref...": "ctg_to_ref",
                  "Align and split...": "align_split"}
STAGE_OPENINGS = ("K-Mer counting...", *ALIGNER_STAGES, "Pre process...",
                  "PAGraph...", "Extract and split...", "Correct...",
                  "Final output:")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def build_all() -> dict:
    """Build the CUDA kernels and the five host cores, all at once.  A core
    that does not build fails the run: the pipeline would quietly take
    its Python specification instead."""
    from aligngraph2_tpu_torch.consensus import native as cns_native
    from aligngraph2_tpu_torch.graph import ingest_native
    from aligngraph2_tpu_torch.io import native as io_native
    from aligngraph2_tpu_torch.ops import _cuda, native as ops_native
    from aligngraph2_tpu_torch.traverse import native as tr_native
    from aligngraph2_tpu_torch.utils.nativebuild import lib_path

    def timed(fn):
        t0 = time.perf_counter()
        lib = fn()
        if lib is None:
            raise RuntimeError(f"{fn.__module__} did not build")
        return time.perf_counter() - t0

    jobs = {"banded_static.cu": _cuda.get_lib,
            "fastio.cpp": io_native.get_lib,
            "seedhits.cpp": ops_native.get_lib,
            "ingest.cpp": ingest_native.get_lib,
            "traverse.cpp": tr_native.get_lib,
            "poacns.cpp": cns_native.get_lib}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in jobs.items()}
        secs = {k: round(f.result(), 3) for k, f in futs.items()}
    with open(lib_path(_cuda.SRC, _cuda.nvcc_cmd()) + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln
                 or "Compiling entry" in ln or "spill" in ln]
    return {"build_s": secs, "ptxas": ptxas, "regs": ptxas_regs(ptxas)}


def ptxas_regs(ptxas) -> dict:
    """{kernel: registers a thread} from ptxas' report, kernels named as
    dp_static_kernel<W> and tb_static_kernel<slots>."""
    regs, name = {}, None
    for ln in ptxas:
        m = re.search(r"(dp_static_kernel|tb_static_kernel)I((?:L[ib]\d+E)+)",
                      ln)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
            name = f"{m.group(1)}<{args}>"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


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


def random_word_lanes(rng, W, dev, B=64, NQ=1024):
    """Random direction codes (1% STOP), packed into words, and best cells,
    a quarter of them at column 0 or W-1: the walks run LEFT past column 0
    and UP past column W-1."""
    import numpy as np
    import torch
    codes = rng.choice(4, (B, NQ // 16, 16, W), p=[0.01, 0.5, 0.25, 0.24])
    words = np.zeros((B, NQ // 16, W), np.uint32)
    for s in range(16):
        words |= codes[:, :, s, :].astype(np.uint32) << np.uint32(2 * s)
    bi = rng.integers(0, NQ + 1, B).astype(np.int32)
    bj = rng.integers(0, W, B).astype(np.int32)
    bj[::8] = 0
    bj[1::8] = W - 1
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (words.view(np.int32), bi, bj))


def gate(args, regs) -> dict:
    """Kernels against their plain versions; returns the timings at the
    kernels line's shape (B=1024, NQ=8192, W=256, x_drop=250)."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.ops import banded_static as bs

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    err = {"dp": 0, "tb": 0}
    timing = {}
    shape = None
    for B, NQ, W, x_drop in GATE:
        if (B, NQ, W) != shape:   # new lanes; both x_drop share them
            shape = (B, NQ, W)
            qd, td, qld = (torch.from_numpy(x).to(dev)
                           for x in planted_lanes(rng, B, NQ, W))
        max_steps = 2 * NQ + W
        kw = dict(W=W, x_drop=x_drop)

        def run_dp():
            return bs.banded_dp_static(qd, td, qld, **kw)

        plain_dp_ms, ref = once_ms(
            lambda: bs.banded_dp_static_ref(qd, td, qld, **kw))
        plain_tb_ms, tbr = once_ms(lambda: bs.traceback_static_ref(
            ref.words, ref.best_i, ref.best_j, max_steps=max_steps))
        rows_ok = (torch.arange(NQ, device=dev)[None, :]
                   < ref.best_i[:, None])
        bad = []

        def differ(key, name, a, r, mask=None):
            d = (a.int() - r.int()).abs()
            d = int((d if mask is None else d * mask).max())
            err[key] = max(err[key], d)
            if d:
                bad.append(name)

        res = run_dp()
        for name in ("score", "best_i", "best_j", "rows"):
            differ("dp", name, getattr(res, name), getattr(ref, name))
        for s in range(0, B, 64):
            differ("dp", f"dirs[{s}:{s + 64}]",
                   bs.unpack_words(res.words[s:s + 64]),
                   bs.unpack_words(ref.words[s:s + 64]),
                   rows_ok[s:s + 64, :, None])
        tb = bs.traceback_static(res.words, res.best_i, res.best_j,
                                 max_steps=max_steps)
        for name, a, r in zip(("moves", "n", "si", "sj"), tb, tbr):
            differ("tb", name, a, r)
        rw = random_word_lanes(rng, W, dev, B=min(64, 32768 // W))
        rw_steps = 2 * rw[0].shape[1] * 16 + W
        for name, a, r in zip(
                ("moves", "n", "si", "sj"),
                bs.traceback_static(*rw, max_steps=rw_steps),
                bs.traceback_static_ref(*rw, max_steps=rw_steps)):
            differ("tb", "random." + name, a, r)
        dp_ms = cuda_ms(run_dp, REPS)
        tb_ms = cuda_ms(lambda: bs.traceback_static(
            res.words, res.best_i, res.best_j, max_steps=max_steps), REPS)
        dp_b, dp_by, cells = dp_bound_ms(res, W, NQ)
        tb_b, tb_by = tb_bound_ms(tb[1], B, max_steps)
        emit({"phase": "gate", "B": B, "NQ": NQ, "W": W,
              "x_drop": x_drop, "exact": not bad, "mismatch": bad,
              "dp_cells": cells,
              "lanes_stopped_early": int((res.rows < NQ).sum()),
              "dp_ms": dp_ms, "dp_plain_ms": plain_dp_ms,
              "dp_bound_ms": dp_b, "dp_bound_by": dp_by,
              "tb_ms": tb_ms, "tb_plain_ms": plain_tb_ms,
              "tb_bound_ms": tb_b, "tb_bound_by": tb_by,
              "tb_moves": int(tb[1].sum()),
              "regs": {k: v for k, v in regs.items()
                       if k == f"dp_static_kernel<{W}>"
                       or k.startswith("tb_static_kernel")}})
        if bad:
            raise SystemExit(f"gate failed at B={B} NQ={NQ} W={W} "
                             f"x_drop={x_drop}: {bad}")
        if (B, NQ, W, x_drop) == GATE[1]:
            timing = dict(dp=(dp_ms, plain_dp_ms, dp_b, dp_by),
                          tb=(tb_ms, plain_tb_ms, tb_b, tb_by))
        del res, tb, ref, tbr, rw
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


def slice_run(args, pool):
    """Stages 2-4 on CUDA, each kernel launched; returns the future of the
    long read's CPU half, started in ``pool`` with the plain phase."""
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

    # the long read's CPU half runs in a child process from here on,
    # beside host-bound work whose walls are not metrics
    on_cpu = pool.submit(long_read_on_cpu, args.seed)
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
    return on_cpu


def long_read_dbs(seed):
    """One read just past the 65536 bucket, planted in a random genome
    made from ``seed``: (reads, target) databases."""
    import numpy as np
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    from tests.synth import mutate, random_genome

    rng = np.random.default_rng(seed + 1)
    genome = random_genome(rng, LONG_READ_BP + 20000)
    read = mutate(rng, genome[10000:10000 + LONG_READ_BP], 0.02, 0.01, 0.01)
    assert len(read) > 65536, len(read)
    return (SeqDatabase([("long_read", read)]),
            SeqDatabase([("genome", genome)]))


def long_read_on_cpu(seed):
    """The long read through the aligner on the CPU: (.ref text, wall s).
    Runs in a child process during the plain phase."""
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig

    reads, target = long_read_dbs(seed)
    t0 = time.perf_counter()
    cpu = LongReadAligner(target, AlignerConfig(),
                          device="cpu").align_reads(reads)
    return cpu.to_ref_text(), time.perf_counter() - t0


def long_read(args, on_cpu) -> None:
    """The long read through the aligner on CUDA.  It must take the
    adaptive band (no static-band launch), as the JAX package sends such
    buckets to its adaptive scan; the .ref text must equal the CPU's, from
    the future ``on_cpu`` of :func:`long_read_on_cpu`."""
    import torch
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.ops import banded_static as bs

    reads, target = long_read_dbs(args.seed)
    bs.banded_dp_static.launches = 0
    bs.traceback_static.launches = 0
    t0 = time.perf_counter()
    cu = LongReadAligner(target, AlignerConfig()).align_reads(reads)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    cpu_text, cpu_s = on_cpu.result()
    static = bs.banded_dp_static.launches + bs.traceback_static.launches
    same = cu.to_ref_text() == cpu_text
    emit({"phase": "long_read", "read_bp": int(reads.lengths[0]),
          "alignments": len(cu),
          "aligned_bp": max((a.qe - a.qb for a in cu), default=0),
          "static_launches": static, "ref_text_equal": same,
          "cuda_s": cuda_s, "cpu_s": cpu_s})
    if static or not same or not len(cu):
        raise SystemExit("long read: static-band launches, no alignment "
                         "or CUDA and CPU .ref text differ")
    check_records(cu, reads, target)


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


def write_inputs(ds, d):
    """reads.fq, ctg.fa, genome.fa (the similar genome) of ``ds`` in
    ``d``, written with the port's io.fasta; returns their paths."""
    from aligngraph2_tpu_torch.io.fasta import write_fasta, write_fastq
    paths = [os.path.join(d, n) for n in ("reads.fq", "ctg.fa", "genome.fa")]
    write_fastq(paths[0], ds["reads"])
    write_fasta(paths[1], ds["contigs"])
    write_fasta(paths[2], ds["similar"])
    return paths


def cli_config(argv):
    """The PipelineConfig the CLI builds from ``argv``."""
    from aligngraph2_tpu_torch import cli
    return cli.config_from_args(cli.build_parser().parse_args(argv))


def identity_to_truth(seq, genome):
    """Matching columns over all columns of ``seq``'s alignments to the
    truth genome through the port's align_chunked, and the share of
    ``seq`` they cover."""
    import numpy as np
    from aligngraph2_tpu_torch.align.aligner import align_chunked
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    alns = align_chunked(SeqDatabase([("truth", genome)]),
                         SeqDatabase([("probe", seq.upper())]),
                         AlignerConfig())
    cols = sum(len(a.qstr) for a in alns)
    same = sum(int(np.count_nonzero(np.frombuffer(a.qstr.encode(), np.uint8)
                                    == np.frombuffer(a.tstr.encode(),
                                                     np.uint8)))
               for a in alns)
    covered = np.zeros(len(seq), bool)
    for a in alns:
        covered[a.qb:a.qe] = True
    return same / max(cols, 1), float(covered.mean()), len(alns)


def pipeline(args) -> dict:
    """The whole pipeline on CUDA at 5 Mb, through run_pipeline with the
    CLI's default config; returns each kernel's launches in the run."""
    import tempfile
    from aligngraph2_tpu_torch.io.fasta import read_seqs
    from aligngraph2_tpu_torch.ops import banded_static as bs
    from aligngraph2_tpu_torch.pipeline.driver import run_pipeline
    from tests.synth import make_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as d:
        t0 = time.perf_counter()
        ds = make_dataset(seed=args.seed, **PIPELINE_DATA)
        paths = write_inputs(ds, d)
        setup_s = time.perf_counter() - t0
        out = os.path.join(d, "out")
        cfg = cli_config(["-r", paths[0], "-c", paths[1], "-g", paths[2],
                          "-o", out])
        cfg.runtime.progress = False
        snaps = []
        graph_s = {"ingest": 0.0, "merge": 0.0}

        def log(msg, *_):
            msg = str(msg)
            if msg.startswith(STAGE_OPENINGS):
                snaps.append((msg, bs.banded_dp_static.launches,
                              bs.traceback_static.launches))
            # stage 6's two passes report their ingest and merge seconds
            m = re.search(r"\(ingest ([\d.]+)s merge ([\d.]+)s\)", msg)
            if m:
                graph_s["ingest"] += float(m.group(1))
                graph_s["merge"] += float(m.group(2))

        bs.banded_dp_static.launches = 0
        bs.traceback_static.launches = 0
        t0 = time.perf_counter()
        res = run_pipeline(*paths, out, cfg, log=log)
        wall = time.perf_counter() - t0
        launches = {"banded_dp_static": bs.banded_dp_static.launches,
                    "traceback_static": bs.traceback_static.launches}
        per_stage = {}
        for (msg, dp, tb), (_, dp2, tb2) in zip(snaps, snaps[1:]):
            for opening, key in ALIGNER_STAGES.items():
                if msg.startswith(opening):
                    per_stage[key] = {"banded_dp_static": dp2 - dp,
                                      "traceback_static": tb2 - tb}
        recs = list(read_seqs(res.final_fasta))
        longest = max(recs, key=lambda r: len(r[1]), default=("", ""))
        longest_ctg = max(len(s) for _, s in ds["contigs"])
        ident, covered, n_alns = (identity_to_truth(longest[1], ds["genome"])
                                  if recs else (0.0, 0.0, 0))
        st = res.stats
        emit({"phase": "pipeline", "genome_bp": len(ds["genome"]),
              "reads": st["n_reads"], "contigs": st["n_contigs"],
              "setup_s": setup_s, "wall_s": wall,
              "reads_per_s": st["n_reads"] / wall,
              "stage_s": st["stage_s"], "stage_rss_mb": st["stage_rss_mb"],
              "pagraph_ingest_s": graph_s["ingest"],
              "pagraph_merge_s": graph_s["merge"],
              "rss_mb": st["rss_mb"], "n_solid": st["n_solid"],
              "n_groups": st["n_groups"], "n_chains": st["n_chains"],
              "consumed": len(st["consumed"]),
              "alignments": {k: st[k] for k in (
                  "n_read_to_ctg", "n_read_to_ref", "n_ctg_to_ref")},
              "launches": launches, "launches_by_stage": per_stage,
              "final_records": len(recs), "longest_bp": len(longest[1]),
              "longest_contig_bp": longest_ctg,
              "identity_to_truth": ident, "covered_share": covered,
              "truth_alignments": n_alns})
    if not st["n_chains"]:
        raise SystemExit("pipeline: no chain, so stages 7 and 8 did not run")
    idle = [key for key in ALIGNER_STAGES.values()
            if not (key in per_stage and all(per_stage[key].values()))]
    if idle:
        raise SystemExit(f"pipeline: a kernel was not launched in {idle}")
    if not recs:
        raise SystemExit("pipeline: final.fasta is empty")
    if len(longest[1]) <= longest_ctg:
        raise SystemExit("pipeline: the longest output is not longer than "
                         "the longest contig")
    if ident <= 0.85:
        raise SystemExit(f"pipeline: identity {ident:.4f} to the truth "
                         "genome is not above 0.85")
    return launches


def cli_run(args) -> None:
    """The CLI as a subprocess on the card, and the same inputs through the
    plain versions in-process: the five outputs must be equal."""
    import tempfile
    from aligngraph2_tpu_torch.pipeline.driver import run_pipeline
    from tests.synth import make_dataset

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        ds = make_dataset(seed=args.seed, **CLI_DATA)
        paths = write_inputs(ds, d)
        argv = ["-r", paths[0], "-c", paths[1], "-g", paths[2], *CLI_FLAGS]
        out_cli, out_plain = (os.path.join(d, n) for n in ("cli", "plain"))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "aligngraph2_tpu_torch.cli", *argv,
             "-o", out_cli], cwd=HERE, capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise SystemExit(f"cli exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
        cfg = cli_config([*argv, "-o", out_plain])
        cfg.runtime.plain = True
        cfg.runtime.progress = False
        t0 = time.perf_counter()
        plain = run_pipeline(*paths[:3], out_plain, cfg, log=lambda *a: None)
        plain_s = time.perf_counter() - t0
        with open(os.path.join(out_cli, "metrics.json")) as f:
            metrics = json.load(f)
        same = {}
        for name in OUTPUTS:
            with open(os.path.join(out_cli, name), "rb") as f1, \
                    open(os.path.join(out_plain, name), "rb") as f2:
                same[name] = f1.read() == f2.read()
        emit({"phase": "cli", "genome_bp": len(ds["genome"]),
              "reads": len(ds["reads"]), "flags": CLI_FLAGS,
              "device": metrics["device"], "n_chains": metrics["n_chains"],
              "plain_n_chains": plain.stats["n_chains"],
              "files_equal": same, "cli_s": cli_s, "plain_s": plain_s,
              "cli_stage_s": metrics["stage_s"],
              "plain_stage_s": plain.stats["stage_s"]})
    if not all(same.values()):
        raise SystemExit(f"cli: outputs differ from the plain run: {same}")
    if metrics["device"] != "cuda" or not metrics["n_chains"]:
        raise SystemExit("cli: not on the card, or no chain formed")


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
    built = build_all()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda, **built})
    timing = gate(args, built["regs"])
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        on_cpu = slice_run(args, pool)
        long_read(args, on_cpu)
    launches = pipeline(args)
    cli_run(args)
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
