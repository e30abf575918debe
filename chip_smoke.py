#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (aligngraph2_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--genome-mb 1]
    python3 chip_smoke.py --cards N      # several cards: see the end

Builds the kernels (three CUDA sources) and the five host cores from this
checkout (nvcc and g++, in parallel), then prints one JSON line per phase:

  card    the card, the build seconds and ptxas' register report; any
          kernel or host core that fails to build fails the run;
  probe   the link probe of utils/devprobe.py: one 16 MB copy each way,
          MB/s up and down, and what ``auto`` resolves to for the merge
          and consensus switches;
  gate    each CUDA kernel against its plain torch version on the card, on
          planted lanes (B=1024, NQ=8192; W=256 and 512; x_drop 0 and
          250; the aligner's batch for the 16384 bucket, B=384, W=256,
          x_drop 250; W=1024 on B=256, NQ=4096; and W=2048 and 4096,
          a group of warps a lane, on B=128, NQ=8192): score, best cell,
          rows run, directions on rows <= best_i, moves, move count and
          start, all exact; the traceback also on random direction words,
          whose walks hit both band edges; kernel times, plain times,
          bounds and registers;
  adaptive_gate the adaptive band's two kernels against their plain
          torch versions on the card (B=32, NQ=8192, W=256 at x_drop 250
          and 0; B=8, NQ=32768; W=64, 128, 512, 1024, 16, 32, 2048 and
          4096 at B=16, NQ=4096), on lanes with indel drift, clustered
          x_drop deaths, short reads and windows, c0 at both clips and
          one lane whose walk is a single DIAG run: score, best cell,
          every row of dirs and centers, moves, move count and start
          (also with max_steps cutting walks, inside that run too), all
          exact; kernel and plain times, cycles a row and a move, bounds
          and registers per shape; at the first W=256 and W=2048 shape
          the cycles a row by phase of lane 0 from a clock64() copy of
          the source run through the same wrapper (its outputs exact
          too);
  stage   stages 2, 3 (with the seed rescue) and 4 of the pipeline on a
          synthetic PacBio dataset, on CUDA at full width, with walls,
          reads/s, DP cells and alignments; launch counts are zeroed before
          stage 2 and read after stage 4, and each kernel must have run;
  plain   the first 200 reads through the plain versions on the card:
          their .ref text must equal the kernels';
  long_read one read just past the 65536 bucket through the aligner on
          CUDA, where it takes the adaptive band as in the JAX package
          (each adaptive kernel launched, no static-band launch, no plain
          version on the card), and on the CPU in a child process
          started with the plain phase: the .ref text must be equal;
          both walls;
  mesh    read -> contig of every read of the stage phase's dataset
          through the mesh path (parallel/) on a 1x1 mesh of the card:
          block-sharded device seeding through the seeder's two kernels
          and extension through the adaptive band's (each of the four
          launched; no static-band launch, no plain version on the card);
          wall, reads/s, lanes, blocks, the device index's bytes, and per
          sharded function its calls, card ms per call (synchronised
          before and after) and bytes bound; a seeder call's and an
          extender call's card time by kind (the kernels, the torch ops,
          the copies each way), every seeder and extender call replayed
          under torch.profiler; the first MESH_CPU_READS reads also
          through the mesh path on the CPU in a second child process:
          their .ref text must be equal;
  mesh_grid the same reads on meshes that list the card four times, 2x2
          and 1x4: the block axis's split and concatenation and a
          per-shard index on a card; each .ref text must equal the mesh
          phase's on every read, each seeder and adaptive kernel must
          launch (no static-band launch, no plain version on the card);
          wall, reads/s, seeder and extender calls;
  seed_gate the histogram kernel (both strands' k-mer codes and
          histograms in one launch) against its plain version (each
          strand's kmer_codes_batch, then the plain histogram) on the
          card, every output exact: on the mesh phase's block index and
          reads, B=32 at NQ=8192 and B=16 at NQ=16384 (bin_w 128), and
          B=8 contig pieces at NQ=131072, bin_w 32; B=32 pieces of a
          synthetic 600-block genome (sorted on the card, 1 GB of index)
          at NQ=8192; and B=32 at NQ=8192 and B=8 at NQ=131072, bin_w 32,
          on the 1 Mb blocks of a synthetic 5.5 Mb genome (~31,500 and
          ~35,300 bins, in the scratch); the grid, kernel and plain ms,
          bound and latency
          model, and the cycles a thread by phase of a clocked copy of
          the kernel (also exact) run through the same wrapper;
  select_gate the dedup kernel against its plain version on the card:
          first on the table's planted edges (pairs 2^31 apart, the
          circle's short last bucket, two targets at equal diagonals,
          bursts inside a batch), then at B=32, N=96, 544, 12,800 and
          32,768 (the 1 Mb, 5 Mb, 120 Mb and ~300 Mb widths; the table
          of kept entries in the scratch past 8192), planted ties, rows
          whose kept list reaches ~29,600 entries, rows at +-2^31 and the
          entry (-1, -1), every output exact; the same numbers, the
          wrapper's stable sort alone, the phase split, and the time must
          grow at most 4x from 12,800 to 32,768;
  profile stage 2 again under torch.profiler: host spans, device time
          by kernel, the card's idle share;
  widths  the entry points at the widths past the defaults, each run's
          launch counts zeroed before it and read after it, no plain
          version on the card: LongReadAligner at band_width 2048, the
          stage dataset's first 200 reads to the contigs (the static
          band at W=2048) and the long read (the adaptive band at 2048),
          each .ref text equal to the plain versions' on the card; and
          the mesh path at band_width 32 on 1 Mb blocks, 200 reads of
          the pipeline phase's dataset to its similar genome (the
          seeder's ~31,500 bins in the scratch, the extender at W=32),
          its first 32 reads equal to the CPU's (a third child process);
          per run reads, reads/s, wall and each kernel's launches and
          card ms a launch by name and W from a profiled rerun;
  pipeline the whole eight-stage pipeline through run_pipeline on CUDA,
          with the config the CLI builds from its default flags and the
          merge and consensus switches at ``device``, on a 5 Mb PacBio
          dataset (bench_e2e.py's recipe): whole wall, reads/s, stage
          walls and RSS, stage 6's ingest and merge seconds (the rest of
          it is graph set-up, subsets and traversal), solid k-mers,
          groups, chains, consumed contigs, and each kernel's launches in
          stages 2, 3, 4 and 7 (each must be nonzero); at least one chain,
          a longest output longer than the longest contig, and identity
          above 0.85 against the truth genome.  The device merge and
          consensus entry points are wrapped in this process for the run
          (DeviceCalls): each call's inputs, outputs and card time are
          kept, with the host<->device copies timed apart;
  device_paths the native C++ core on each kept input: every output must
          equal the device path's; per call its sizes, card ms, copies ms,
          native ms, bytes and their bound, and the same per function;
  merge_sweep the positions merge, device against native core, on
          prefixes of 10^5, 10^6 and 10^7 rows of the largest kept input
          (outputs equal): where the device stops winning;
  cli     ``python -m aligngraph2_tpu_torch.cli`` as a subprocess on the
          card with both switches at their default ``auto``, flags only,
          on a small dataset, and the same inputs run in-process through
          the plain versions and the native cores: the five output files
          must be byte-identical;
  total   the script's wall so far;
  kernels one entry per CUDA kernel with its launches (the static
          band's in the pipeline and widths phases, the adaptive band's
          in the long_read, mesh, mesh_grid and widths phases, the
          seeder's in the mesh, mesh_grid and widths phases), error,
          times and bound.

then the card's name and power limit as nvidia-smi prints them and, last,
{"ok": true, "device": {...}}.  Any failure exits nonzero before that
line; so does a machine without CUDA or a directory without the package.

With ``--cards N`` (N >= 2 cards present, else it fails) the script
builds, prints every card's line and the probe, and runs only these
phases, on cards 0 .. N-1 (the one-card phases take the single-device
path, which is not the default on such a host); each fails rather than
skips:

  cards_mesh read -> contig of every read of the stage dataset on the
          1x1 mesh of card 0, then on meshes of real cards (2x1 and 1x2;
          past two cards N x 1, N/2 x 2 and 1 x N): .ref text equal to
          card 0's on every read; every card launches the seed kernel
          and both adaptive kernels, the dedup kernel runs on each data
          row's first card; the current card unchanged by each run and by
          seed_block and banded_align called directly on the last card;
          wall, reads/s, seeder and extender calls, bytes copied between
          cards, launches by kernel and card;
  cards_pipeline the pipeline phase's 5 Mb dataset through the CLI at its
          defaults in one process on the N cards (the mesh on, 2x2 at
          four) and on card 0 with sharded_align on (1x1): the five
          outputs equal; then on card 0 at the defaults (the
          single-device path); stage walls, identity to the truth;
  cards_processes the cli phase's dataset through the CLI in the
          torchrun environment: N processes of one card each (the mesh
          off) against one process on card 0, N/2 processes of two cards
          each (a 2x1 mesh each) against one on card 0 with a 1x1 mesh;
          the five outputs and the solid set equal, the k-mer count sum on
          each process's card (NCCL), no process allocating on a card it
          does not own;
  cards_launches each kernel's launches by card in these phases;

then every card's line and the contract line, its count the cards
present.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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
        (256, 4096, 1024, 250),   # the widest band of one warp a lane
        # the aligner's batch at band_width 2048 and 4096 (a group of
        # warps a lane; 0.5 and 1 GiB of words)
        (128, GATE_NQ, 2048, 250), (128, GATE_NQ, 4096, 250))
# (B, NQ, W, x_drop) of the adaptive gate, NT = NQ + 2W: the mesh
# extender's lanes at the 8192 and 32768 buckets (the kernels line reads
# the first), the first at x_drop 0, and every other band the kernels take
# (one column a thread at 16 and 32, a group of warps a lane at 2048 and
# 4096)
ADAPTIVE_GATE = ((32, 8192, 256, 250), (8, 32768, 256, 250),
                 (32, 8192, 256, 0), (16, 4096, 64, 250),
                 (16, 4096, 128, 250), (16, 4096, 512, 250),
                 (16, 4096, 1024, 250), (16, 4096, 16, 250),
                 (16, 4096, 32, 250), (16, 4096, 2048, 250),
                 (16, 4096, 4096, 250))
# the widths at whose first gate shape the clocked copy of the adaptive
# DP runs: one warp a lane, and a group of two
ADAPTIVE_CLOCKED = (256, 2048)
DIAG_LANE = 7   # the adaptive gate's lane whose walk is one DIAG run
# one DP row's dependent chain on the card, a model: ten warp-wide steps
# (two reductions, the neighbour and query shuffles, five scan shuffles
# and the carry) of ~30 cycles, and three dependent int32 operations a
# column of the thread (prefix, fix-up, mask) of ~4 cycles; one traceback
# step: a shared-memory load and ~6 dependent operations
SM_CLOCK_HZ = 1.98e9
TB_STEP_CHAIN_CYCLES = 60
LONG_READ_BP = 66000           # past the 65536 bucket
REPS = 5
PLAIN_READS = 200
MESH_CPU_READS = 32            # the mesh phase's first reads, also on
                               # the CPU (the card takes all of them)
# the widths phase: band_width 2048 on one device (the static band at
# W = 2048 for the stage dataset's first WIDTHS_READS reads, the adaptive
# band at 2048 for the long read), and the mesh path at band_width 32 on
# 1 Mb blocks (bin_w 32: ~31,500 bins, past one block's shared memory)
# for WIDTHS_READS reads of the pipeline phase's dataset to its similar
# genome (its first MESH_CPU_READS also on the CPU)
WIDTHS_BAND = 2048
WIDTHS_MESH = dict(band_width=32, block_size=1_000_000)
WIDTHS_READS = 200
# the mesh_grid phase: meshes that list the one card four times, with 2
# and 4 devices on the block axis (2x2 and 1x4)
MESH_GRID = (2, 4)
# the kernel each wrapper names when it checks its launch (ops/_cuda.py
# ``check``): the per-card launch counts of CardLaunches
KERNEL_OF_LAUNCH = {"dp_static_kernel launch": "banded_dp_static",
                    "tb_static_kernel launch": "traceback_static",
                    "dp_adaptive_kernel launch": "banded_align",
                    "tb_adaptive_kernel launch": "traceback",
                    "seed_block_kernel launch": "seed_block",
                    "select_candidates_kernel launch": "select_candidates"}
# the --cards phases' subprocesses: seconds each may take
CARDS_PIPELINE_TIMEOUT = 600
CARDS_CLI_TIMEOUT = 300
MERGE_SWEEP_ROWS = (10 ** 5, 10 ** 6, 10 ** 7)
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
# the backend switches of stage 6's merges and stage 8's aggregation
SWITCHES = ("ALIGNGRAPH2_TPU_TORCH_MERGE", "ALIGNGRAPH2_TPU_TORCH_CONSENSUS")
# each device function of the device paths: the XLA function it replaces
DEVICE_FUNCTIONS = {
    "merge_positions_device": "aligngraph2_tpu/graph/merge_device.py:48",
    "merge_edges_device": "aligngraph2_tpu/graph/merge_device.py:74",
    "_agg_columns": "aligngraph2_tpu/consensus/device.py:197",
    "_chain_sort": "aligngraph2_tpu/consensus/device.py:306"}
# each function of the mesh path (parallel/sharded.py): the XLA function
# it replaces
# (reads B, NQ, bin_w, index blocks, block length) of the seed gate, each
# launch seeding both strands of B reads: the mesh phase's 8192 and 16384
# buckets on its index (blocks 0; the kernels line reads the first), the
# widest bins at the longest bucket, where hist and dsum take more than
# 48 KB of shared memory, and the first bucket against a synthetic index
# of 600 blocks of the mesh's block length and overlap (block length 0; a
# 90 Mb genome, 1 GB on the card); then the bins past one block's shared
# memory (the scratch): the 8192 bucket and the contig pieces' 131072 at
# bin_w 32 against the 1 Mb blocks of a 5.5 Mb genome (-b 1000, ~31,500
# and ~35,300 bins)
SEED_GATE = ((32, 8192, 128, 0, 0), (16, 16384, 128, 0, 0),
             (8, 131072, 32, 0, 0), (32, 8192, 128, 600, 0),
             (32, 8192, 32, 7, 1_000_000), (8, 131072, 32, 7, 1_000_000))
SEED_OCC, SEED_MAX_OCC = 4, 256
# N candidates a read in the select gate: 1 Mb (6 blocks), 5 Mb (34),
# 120 Mb (800) and ~300 Mb (2,048) targets at K = 8 (the kernels line
# reads the first); past N = 8192 the kernel's table of kept entries is
# in the wrapper's scratch, not in shared memory
SELECT_GATE_N = (96, 544, 12800, 32768)
SELECT_GATE_B = 32
# calls of a plain version timed, after a warm-up call
PLAIN_REPS = 3
# latency models (models, not measurements): an L2 hit, an L1 hit and a
# shared memory step; an SM's shared memory; a dedup batch's near matrix
# (shuffles over the earlier lanes of the same target)
L2_HIT_CYCLES = 260
L1_HIT_CYCLES = 35
SHARED_STEP_CYCLES = 30
SM_SHARED_BYTES = 228 * 1024
SELECT_MATRIX_CYCLES = 150
# operations of the least work (the bounds, not the kernels' algorithms)
SEED_CODE_OPS = 3       # a position's rolling k-mer code: shift, or, mask
SEED_HASH_OPS = 4       # a block's code into a hash table of (lo, n), or a
                        # query code's probe: hash, load, compare, select
SEED_HIT_OPS = 10       # gather, diagonal, floor division, clamp, 2 adds
SEED_BIN_OPS = 4        # a touched bin of one top-T pass: pair, key,
                        # compare
SELECT_OPS = 8          # a candidate: 3 gathers, compare, mean, clamp, pick
SELECT_PROBE_OPS = 4    # a probe of the kept table: hash, load, 2 compares
MESH_FUNCTIONS = {
    "_seed_reads": "aligngraph2_tpu/parallel/sharded.py:126",
    "_select_read_candidates": "aligngraph2_tpu/parallel/sharded.py:171",
    "_seed_body": "aligngraph2_tpu/parallel/sharded.py:223",
    "_extend_body": "aligngraph2_tpu/parallel/sharded.py:294"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> list:
    """Each card's name and power limit, a line a card, as nvidia-smi
    prints them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()


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
            "banded_adaptive.cu": _cuda.get_adaptive_lib,
            "seed_mesh.cu": _cuda.get_seed_lib,
            "seed_mesh.cu, clocked": seed_clock_lib,
            "banded_adaptive.cu, clocked": adaptive_clock_lib,
            "fastio.cpp": io_native.get_lib,
            "seedhits.cpp": ops_native.get_lib,
            "ingest.cpp": ingest_native.get_lib,
            "traverse.cpp": tr_native.get_lib,
            "poacns.cpp": cns_native.get_lib}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in jobs.items()}
        secs = {k: round(f.result(), 3) for k, f in futs.items()}
    ptxas = []
    for src in _cuda.SOURCES:
        with open(lib_path(src, _cuda.nvcc_cmd()) + ".log") as f:
            ptxas += [ln.strip() for ln in f if "registers" in ln
                      or "Compiling entry" in ln or "spill" in ln]
    return {"build_s": secs, "ptxas": ptxas, "regs": ptxas_regs(ptxas)}


def ptxas_regs(ptxas) -> dict:
    """{kernel: registers a thread} from ptxas' report, kernels named as
    dp_static_kernel<W>, tb_static_kernel<slots>, dp_adaptive_kernel<W>,
    tb_adaptive_kernel<slots>, seed_block_kernel and
    select_candidates_kernel."""
    regs, name = {}, None
    for ln in ptxas:
        m = re.search(r"((?:dp|tb)_(?:static|adaptive)_kernel)"
                      r"I((?:L[ib]\d+E)+)", ln)
        if m:
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
            name = f"{m.group(1)}<{args}>"
        m = re.search(r"\d(seed_block_kernel|select_candidates_kernel)", ln)
        if m and "Compiling entry" in ln:
            name = m.group(1)
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


def drifted_read(rng, t, start, n, p_sub, p_ins, p_del):
    """n query bases read off target ``t`` from position ``start``, with
    substitutions, insertions (a random base, the diagonal falls by one)
    and deletions (a target base skipped, the diagonal rises by one); past
    either end of ``t`` the bases are random."""
    import numpy as np
    kind = rng.choice(3, size=n + n // 2, p=[p_ins, p_del, 1 - p_ins - p_del])
    noise = rng.integers(0, 4, kind.size)
    sub = rng.random(kind.size) < p_sub
    out = np.empty(n, np.uint8)
    x, k = start, 0
    for e in range(kind.size):
        if k == n:
            break
        if kind[e] == 1:
            x += 1
            continue
        if kind[e] == 0 or sub[e] or not 0 <= x < len(t):
            out[k] = noise[e]
        else:
            out[k] = t[x]
        x += kind[e] == 2
        k += 1
    out[k:] = noise[:n - k]
    return out


def adaptive_lanes(rng, B, NQ, W):
    """Lanes for the adaptive band, NT = NQ + 2W, eight kinds by b mod 8:
    reads whose indel drift carries the best diagonal 3W/4 (at most NQ/4)
    above (0) or below (1) c0; a short read in a short window (2); reads
    that turn random at rows clustered within a few dozen rows (3, 4), so
    x_drop stops them at different rows of one 64-row chunk; c0 near -W
    (5) and near NT (6), where the band reads sentinels past both ends and
    hits both clips; a random read (7).  Returns (q, qlen, t, tlen, c0), with
    zero padding past qlen and tlen, as the aligner pads."""
    import numpy as np
    NT = NQ + 2 * W
    q = np.zeros((B, NQ), np.uint8)
    t = rng.integers(0, 4, (B, NT)).astype(np.uint8)
    qlen = np.full(B, NQ, np.int32)
    tlen = np.full(B, NT, np.int32)
    c0 = np.full(B, W, np.int32)
    slope = min(0.75 * W / NQ, 0.25)
    for b in range(B):
        kind, rank = b % 8, b // 8
        if kind == 0:
            read = drifted_read(rng, t[b], W, NQ, 0.05, 0.005,
                                0.005 + slope)
        elif kind == 1:
            c0[b] = W + W // 2
            read = drifted_read(rng, t[b], c0[b], NQ, 0.05, 0.005 + slope,
                                0.005)
        elif kind == 2:
            qlen[b] = NQ // 2 + int(rng.integers(0, NQ // 4))
            tlen[b] = W + qlen[b] // 2
            t[b, tlen[b]:] = 0
            read = drifted_read(rng, t[b], W, NQ, 0.05, 0.01, 0.01)
        elif kind in (3, 4):
            read = drifted_read(rng, t[b], W, NQ, 0.05, 0.01, 0.01)
            turn = NQ // (8 if kind == 3 else 2) + 7 * rank
            read[turn:] = rng.integers(0, 4, NQ - turn)
        elif kind == 5:
            c0[b] = -W + int(rng.integers(-8, 9))
            read = drifted_read(rng, t[b], c0[b], NQ, 0.05, 0.01, 0.01)
        elif kind == 6:
            c0[b] = NT + int(rng.integers(-12, 9))
            read = drifted_read(rng, t[b], c0[b] - NQ // 64, NQ, 0.05,
                                0.01, 0.01)
        else:
            read = rng.integers(0, 4, NQ).astype(np.uint8)
        q[b, :qlen[b]] = read[:qlen[b]]
    return q, qlen, t, tlen, c0


def diag_lane(lanes, W, b=DIAG_LANE):
    """Lane ``b`` of ``adaptive_lanes``' output (a random read) replaced, in
    place, by the target itself read from column W/2 of row 1 (c0 = W): the
    band never drifts, the best cell is the last row's, and the walk is
    one DIAG run from row NQ to row 0."""
    q, qlen, t, tlen, c0 = lanes
    NQ = q.shape[1]
    q[b] = t[b, W:W + NQ]
    qlen[b], tlen[b], c0[b] = NQ, t.shape[1], W
    return lanes


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


def warm_ms(fn, reps):
    """(Mean milliseconds per call over ``reps`` calls after a warm-up
    call, the warm-up's output): for the plain versions, whose first call
    on the card pays for torch's set-up."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


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


def adaptive_bounds(rows, B, NQ, W, steps, max_steps):
    """Least times of the adaptive band's kernels on these inputs: (DP
    bound ms, its kind, DP latency ms, traceback bound ms, its kind,
    traceback latency ms).  DP: the rows each lane ran, W cells a row, at
    DP_OPS_PER_CELL against the int32 rate; bytes: q and the band's t read
    for those rows, their direction bytes and every centre written,
    per-lane scalars.  Traceback: TB_OPS_PER_STEP a move; a direction byte
    and a centre read a move, the dense moves written, per-lane scalars.
    Latency: the longest lane's rows (moves) times one row's (move's)
    dependent chain (ten warp steps of ~30 cycles, three dependent
    operations of ~4 cycles a column of the thread, and past W = 1024
    the group's barrier and its reads of the other warps' values)."""
    rows_all = int(rows.sum())
    cells = rows_all * W
    dp_bytes = 2 * rows_all + B * W + cells + B * (NQ + 1) * 4 + B * 4 * 7
    dp_ops_ms = cells * DP_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
    dp_bytes_ms = dp_bytes / HBM_BYTES_PER_S * 1e3
    # a thread's columns (one at W <= 32, 32 in a group of warps), and
    # past W = 1024 the group's barrier (~40 cycles) and a shared read
    # of each warp's values (~30 cycles a warp)
    row_chain = (10 * 30 + 3 * 4 * min(max(W // 32, 1), 32)
                 + (40 + 30 * (W // 1024) if W > 1024 else 0))
    dp_lat_ms = int(rows.max()) * row_chain / SM_CLOCK_HZ * 1e3
    n_steps = int(steps.sum())
    tb_bytes = 5 * n_steps + B * max_steps + B * 4 * 7
    tb_ops_ms = n_steps * TB_OPS_PER_STEP / INT32_OPS_PER_S * 1e3
    tb_bytes_ms = tb_bytes / HBM_BYTES_PER_S * 1e3
    tb_lat_ms = int(steps.max()) * TB_STEP_CHAIN_CYCLES / SM_CLOCK_HZ * 1e3
    return (max(dp_ops_ms, dp_bytes_ms),
            "operations" if dp_ops_ms >= dp_bytes_ms else "bytes", dp_lat_ms,
            max(tb_ops_ms, tb_bytes_ms),
            "operations" if tb_ops_ms >= tb_bytes_ms else "bytes", tb_lat_ms)


def adaptive_gate(args, regs) -> dict:
    """The adaptive band's kernels against their plain versions on the
    card, on adaptive_lanes at each ADAPTIVE_GATE shape, lane DIAG_LANE
    one DIAG run (diag_lane): score, best cell, every row of dirs and
    centers, and the traceback's moves, count and start at max_steps =
    NQ + NT, NQ/2 and NQ/2 + 7 (which cut the longer walks, the DIAG
    lane's inside its run), all exact.  Prints kernel and plain ms,
    cycles a row and a move (at SM_CLOCK_HZ), bounds and registers per
    shape; returns the timings at the first shape."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.ops import banded_dp as bd

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed + 2)
    err = {"dp": 0, "tb": 0}
    timing = {}
    clocked = set()
    for B, NQ, W, x_drop in ADAPTIVE_GATE:
        NT = NQ + 2 * W
        lanes = tuple(torch.from_numpy(x).to(dev) for x in diag_lane(
            adaptive_lanes(rng, B, NQ, W), W))
        kw = dict(W=W, x_drop=x_drop)
        bad = []

        def differ(key, name, a, r):
            d = int((a.int() - r.int()).abs().max()) if a.numel() else 0
            err[key] = max(err[key], d)
            if d:
                bad.append(name)

        plain_dp_ms, ref = once_ms(lambda: bd.banded_align_ref(*lanes, **kw))
        res = bd.banded_align(*lanes, **kw)
        for name in bd.BandedResult._fields:
            differ("dp", name, getattr(res, name), getattr(ref, name))
        walks = {}
        for max_steps in (NQ + NT, NQ // 2, NQ // 2 + 7):
            ms, tbr = once_ms(lambda: bd.traceback_ref(
                ref.dirs, ref.centers, ref.best_i, ref.best_j,
                max_steps=max_steps))
            tb = bd.traceback(res.dirs, res.centers, res.best_i, res.best_j,
                              max_steps=max_steps)
            for name, a, r in zip(("moves", "n", "si", "sj"), tb, tbr):
                differ("tb", f"{name}@{max_steps}", a, r)
            walks[max_steps] = (tb, ms)
        tb, plain_tb_ms = walks[NQ + NT]
        split = None
        if W in ADAPTIVE_CLOCKED and W not in clocked:
            clocked.add(W)
            split, cres = adaptive_phase_split(
                W, lambda: bd.banded_align(*lanes, **kw))
            for name in bd.BandedResult._fields:
                differ("dp", f"clocked {name}", getattr(cres, name),
                       getattr(ref, name))
        _, rows = bd.dp_adaptive(*lanes, match=2, mismatch=-4, gap=-3, **kw)
        dp_ms = cuda_ms(lambda: bd.banded_align(*lanes, **kw), REPS)
        tb_ms = cuda_ms(lambda: bd.traceback(
            res.dirs, res.centers, res.best_i, res.best_j,
            max_steps=NQ + NT), REPS)
        dp_b, dp_by, dp_lat, tb_b, tb_by, tb_lat = adaptive_bounds(
            rows, B, NQ, W, tb[1], NQ + NT)
        diag_moves = tb[0][DIAG_LANE, :int(tb[1][DIAG_LANE])]
        if int(tb[1][DIAG_LANE]) != NQ or bool((diag_moves != bd.DIAG).any()):
            bad.append("diag_lane_walk")
        # how far the band's centre moved from row 1 to the last row run
        # on the lanes with planted drift (kinds 0 and 1): past W/2
        drift = (torch.arange(B, device=dev) % 8) < 2
        moved = (ref.centers.gather(1, rows[:, None].long())
                 - ref.centers[:, 1:2]).abs()[drift]
        emit({"phase": "adaptive_gate", "B": B, "NQ": NQ, "NT": NT, "W": W,
              "x_drop": x_drop, "exact": not bad, "mismatch": bad,
              "rows_run": int(rows.sum()), "longest_lane_rows":
              int(rows.max()), "lanes_stopped_early": int((rows < NQ).sum()),
              "planted_drift_max": int(moved.max()),
              "walks_cut_at_nq_half": int((walks[NQ // 2][0][1]
                                           == NQ // 2).sum()),
              "walks_cut_at_nq_half_plus_7": int((walks[NQ // 2 + 7][0][1]
                                                  == NQ // 2 + 7).sum()),
              "dp_ms": dp_ms, "dp_plain_ms": plain_dp_ms,
              "dp_cycles_per_row": dp_ms * 1e-3 * SM_CLOCK_HZ
              / int(rows.max()),
              "dp_bound_ms": dp_b, "dp_bound_by": dp_by,
              "dp_latency_bound_ms": dp_lat,
              "tb_ms": tb_ms, "tb_plain_ms": plain_tb_ms,
              "tb_cycles_per_move": tb_ms * 1e-3 * SM_CLOCK_HZ
              / max(int(tb[1].max()), 1),
              "tb_bound_ms": tb_b, "tb_bound_by": tb_by,
              "tb_latency_bound_ms": tb_lat, "tb_moves": int(tb[1].sum()),
              "tb_longest_walk": int(tb[1].max()),
              "dp_phase_split": split,
              "regs": {k: v for k, v in regs.items()
                       if k.startswith((f"dp_adaptive_kernel<{W},",
                                        f"tb_adaptive_kernel<{W},"))}})
        if bad:
            raise SystemExit(f"adaptive_gate failed at B={B} NQ={NQ} W={W} "
                             f"x_drop={x_drop}: {bad}")
        if (B, NQ, W, x_drop) == ADAPTIVE_GATE[0]:
            timing = dict(dp=(dp_ms, plain_dp_ms, dp_b, dp_by),
                          tb=(tb_ms, plain_tb_ms, tb_b, tb_by))
        del res, ref, tb, walks, lanes
    timing["err"] = err
    return timing


class RefCalls:
    """Counts the calls of the adaptive band's and the mesh seeder's plain
    versions (the seeder's k-mer codes among them) on CUDA tensors while
    open: the main path must take the kernels.  The package's modules
    call them through module attributes, which is what is replaced; no
    package file changes."""

    def __enter__(self):
        import torch
        from aligngraph2_tpu_torch.align import aligner
        from aligngraph2_tpu_torch.ops import banded_dp
        from aligngraph2_tpu_torch.parallel import sharded
        self.cuda_calls = 0
        self._saved = [(mod, name, getattr(mod, name)) for mod, name in (
            (banded_dp, "banded_align_ref"), (banded_dp, "traceback_ref"),
            (aligner, "banded_align_ref"), (aligner, "traceback_ref"),
            (sharded, "_seed_reads_ref"), (sharded, "kmer_codes_batch"),
            (sharded, "_seed_block_candidates_ref"),
            (sharded, "_select_read_candidates_ref"))]

        def wrap(fn):
            def call(x, *args, **kw):
                if torch.is_tensor(x) and x.is_cuda:
                    self.cuda_calls += 1
                return fn(x, *args, **kw)
            return call

        for mod, name, fn in self._saved:
            setattr(mod, name, wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def adaptive_launches() -> dict:
    from aligngraph2_tpu_torch.ops import banded_dp as bd
    return {"banded_align": bd.banded_align.launches,
            "traceback": bd.traceback.launches}


def seed_launches() -> dict:
    from aligngraph2_tpu_torch.parallel import sharded
    return {"seed_block": sharded.seed_block.launches,
            "select_candidates": sharded.select_candidates.launches}


def zero_launches() -> None:
    """Every kernel's launch count set to 0."""
    from aligngraph2_tpu_torch.ops import banded_dp as bd
    from aligngraph2_tpu_torch.ops import banded_static as bs
    from aligngraph2_tpu_torch.parallel import sharded
    for fn in (bs.banded_dp_static, bs.traceback_static, bd.banded_align,
               bd.traceback, sharded.seed_block, sharded.select_candidates):
        fn.launches = 0


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


def stage_dataset(seed, genome_mb):
    """The stage phase's synthetic PacBio dataset."""
    from tests.synth import make_dataset
    return make_dataset(seed=seed, genome_len=int(genome_mb * 1e6),
                        coverage=20, mean_read=9000, read_err=0.13,
                        similar_div=0.01, profile="pacbio")


def slice_run(args, pool):
    """Stages 2-4 on CUDA, each kernel launched; starts the CPU halves of
    the long_read and mesh phases in ``pool`` with the plain phase.
    Returns their futures and the dataset's reads and contigs."""
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    from aligngraph2_tpu_torch.ops import banded_static as bs

    t0 = time.perf_counter()
    ds = stage_dataset(args.seed, args.genome_mb)
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

    # the CPU halves of long_read and mesh run in a child process from
    # here on, beside host-bound work whose walls are not metrics
    on_cpu = pool.submit(long_read_on_cpu, args.seed)
    mesh_cpu = pool.submit(mesh_on_cpu, args.seed, args.genome_mb)
    widths_cpu = pool.submit(widths_mesh_on_cpu, args.seed)
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
    return on_cpu, mesh_cpu, widths_cpu, reads, ctgs


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


def long_read(args, on_cpu) -> dict:
    """The long read through the aligner on CUDA.  It must take the
    adaptive band's kernels (each launched, no static-band launch, no
    plain version on the card), as the JAX package sends such buckets to
    its adaptive scan; the .ref text must equal the CPU's, from the future
    ``on_cpu`` of :func:`long_read_on_cpu`.  Returns the adaptive kernels'
    launches."""
    import torch
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.ops import banded_static as bs

    reads, target = long_read_dbs(args.seed)
    zero_launches()
    with RefCalls() as rc:
        t0 = time.perf_counter()
        cu = LongReadAligner(target, AlignerConfig()).align_reads(reads)
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t0
    launches = adaptive_launches()
    cpu_text, cpu_s = on_cpu.result()
    static = bs.banded_dp_static.launches + bs.traceback_static.launches
    same = cu.to_ref_text() == cpu_text
    emit({"phase": "long_read", "read_bp": int(reads.lengths[0]),
          "alignments": len(cu),
          "aligned_bp": max((a.qe - a.qb for a in cu), default=0),
          "static_launches": static, "adaptive_launches": launches,
          "plain_calls_on_card": rc.cuda_calls, "ref_text_equal": same,
          "cuda_s": cuda_s, "cpu_s": cpu_s})
    if static or not same or not len(cu):
        raise SystemExit("long read: static-band launches, no alignment "
                         "or CUDA and CPU .ref text differ")
    if not all(launches.values()) or rc.cuda_calls:
        raise SystemExit(f"long read: an adaptive kernel never ran "
                         f"({launches}) or a plain version ran on the card "
                         f"({rc.cuda_calls} calls)")
    check_records(cu, reads, target)
    return launches


def mesh_on_cpu(seed, genome_mb):
    """The stage dataset's first MESH_CPU_READS reads through the mesh
    path on a 1x1 mesh of the CPU, to the contigs: (.ref text, wall s).
    Runs in a child process during the plain phase."""
    import torch
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    from aligngraph2_tpu_torch.parallel.mesh import make_mesh

    # one thread: the batches are a few lanes wide, so torch's thread pool
    # would only contend with the parent process for the cores
    torch.set_num_threads(1)
    ds = stage_dataset(seed, genome_mb)
    reads = SeqDatabase(ds["reads"])
    t0 = time.perf_counter()
    alns = LongReadAligner(
        SeqDatabase(ds["contigs"]), AlignerConfig(),
        mesh=make_mesh(devices=[torch.device("cpu")])).align_reads(
            reads, ids=range(min(MESH_CPU_READS, len(reads))))
    return alns.to_ref_text(), time.perf_counter() - t0


class MeshCalls:
    """The sharded functions of the mesh path (MESH_FUNCTIONS), wrapped in
    this process while open: per function its calls, card ms (the card
    synchronised before and after each call) and the bytes of its tensors,
    inputs and outputs each once; ``lanes`` counts the live lanes
    ``_extend_body`` took.  The extenders that make_sharded_extender
    builds are wrapped too: ``extender`` holds their calls and ms (host
    arrays in and out, so the copies each way included), and ``replay``
    the inputs of every call with a live lane; the seeders that
    make_sharded_seeder builds keep the inputs of every call in
    ``seeder_replay`` (the device index by reference).  The seeder and
    extender call these through module attributes, which is what is
    replaced; no package file changes."""

    def __enter__(self):
        from aligngraph2_tpu_torch.parallel import sharded
        self._mod = sharded
        self.stats = {n: {"calls": 0, "ms": 0.0, "bytes": 0}
                      for n in MESH_FUNCTIONS}
        self.lanes = 0
        self.extender = {"calls": 0, "ms": 0.0}
        self.replay = []
        self.seeder_replay = []
        self._saved = {n: getattr(sharded, n) for n in MESH_FUNCTIONS}
        for n in ("make_sharded_extender", "make_sharded_seeder"):
            self._saved[n] = getattr(sharded, n)
        for name, fn in self._saved.items():
            setattr(sharded, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._mod, name, fn)

    def _wrap_extender(self, ext):
        def call(*arrays):
            ms, out = synced_ms(ext, *arrays)
            self.extender["calls"] += 1
            self.extender["ms"] += ms
            if arrays[1].any():
                self.replay.append((ext, [x.copy() for x in arrays]))
            return out
        return call

    def _wrap_seeder(self, seeder):
        def call(*arrays):
            self.seeder_replay.append(
                (seeder, [x.copy() for x in arrays[:3]] + list(arrays[3:])))
            return seeder(*arrays)
        return call

    def _wrap(self, name, fn):
        if name == "make_sharded_extender":
            return lambda *a, **kw: self._wrap_extender(fn(*a, **kw))
        if name == "make_sharded_seeder":
            return lambda *a, **kw: self._wrap_seeder(fn(*a, **kw))

        def call(*args, **kw):
            ms, out = synced_ms(fn, *args, **kw)
            st = self.stats[name]
            st["calls"] += 1
            st["ms"] += ms
            st["bytes"] += tensor_bytes(args, out)
            if name == "_extend_body":
                self.lanes += int((args[1] > 0).sum())
            return out
        return call


def replay_card_ms(replay, kinds) -> tuple:
    """The calls in ``replay`` ((fn, args) pairs) run again under
    torch.profiler: (wall ms per call, {kind: card ms per call}), card
    time by the first of ``kinds`` (name part -> kind) in each event's
    name, the rest under ``torch_ops``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for fn, args in replay:
            fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    n = max(len(replay), 1)
    device = dict.fromkeys([*kinds.values(), "torch_ops"], 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kind = next((v for k, v in kinds.items() if k in e.key),
                        "torch_ops")
            device[kind] += e.self_device_time_total / 1e3 / n
    return wall_ms / n, device


COPIES = {"Memcpy HtoD": "copies_to_card", "Memcpy DtoH": "copies_to_host"}


def extender_split(mc) -> dict:
    """Where an extender call's time goes: the extender calls that
    MeshCalls kept (all with a live lane), replayed under torch.profiler,
    card time by kind per call (the two kernels, the wrappers' torch ops:
    dirs and moves zeroed, fill_centers, the centres gather, and the
    copies each way), beside the run's ms per whole extender call (host
    arrays in and out) and per ``_extend_body`` call (device tensors in
    and out)."""
    wall, device = replay_card_ms(mc.replay, {
        "dp_adaptive_kernel": "dp_kernel", "tb_adaptive_kernel": "tb_kernel",
        **COPIES})
    body = mc.stats["_extend_body"]
    return {"calls": mc.extender["calls"],
            "call_ms": mc.extender["ms"] / max(mc.extender["calls"], 1),
            "body_ms": body["ms"] / max(body["calls"], 1),
            "replayed": len(mc.replay), "replay_wall_ms_per_call": wall,
            "replay_card_ms_per_call": device}


def seeder_split(mc) -> dict:
    """Where a seeder call's time goes: every seeder call of the run
    replayed under torch.profiler, card time by kind per call (the two
    kernels, the dedup's stable sort, the other torch ops; the copies
    each way), beside the run's ms per ``_seed_body`` call."""
    wall, device = replay_card_ms(mc.seeder_replay, {
        "seed_block_kernel": "seed_block_kernel",
        "select_candidates_kernel": "select_kernel", "Sort": "sort",
        "sort": "sort", **COPIES})
    body = mc.stats["_seed_body"]
    return {"calls": body["calls"],
            "body_ms": body["ms"] / max(body["calls"], 1),
            "replayed": len(mc.seeder_replay),
            "replay_wall_ms_per_call": wall,
            "replay_card_ms_per_call": device}


# clock64() phase timers for a copy of csrc/seed_mesh.cu
# (seed_clock_lib): (text, replacement) edits, each text found exactly
# once in the source.  CLK(k) adds a thread's cycles since its last mark
# to its phase k; at its end each warp adds its threads' sums to g_clk[k]
# and 32 to g_clk[7].
SEED_CLOCK_HEAD = """
__device__ unsigned long long g_clk[8];
#define CLK(k) do { long long t_ = clock64(); clk_[k] += t_ - tp_; \\
                    tp_ = t_; } while (0)
#define CLK_SAVE() do { for (int k_ = 0; k_ < 6; ++k_) { \\
      long long v_ = clk_[k_]; \\
      for (int o_ = 16; o_; o_ >>= 1) \\
        v_ += __shfl_xor_sync(0xffffffffu, v_, o_); \\
      if ((threadIdx.x & 31) == 0) \\
        atomicAdd(&g_clk[k_], (unsigned long long)v_); } \\
    if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[7], 32ull); } while (0)
"""
SEED_CLOCK_TAIL = """
extern "C" int agc_read_clk(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(long long) * 8);
}
extern "C" int agc_reset_clk() {
  unsigned long long z[8] = {};
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
}
"""
_CLK_INIT = "  long long clk_[6] = {}; long long tp_ = clock64();\n"
SEED_PHASES = {
    "seed_block_kernel": (
        "zero bins, cluster barrier", "k-mer codes and search",
        "hits: aggregated atomics into the leader's bins",
        "cluster barrier after the positions", "top-T rounds (the leader)"),
    "select_candidates_kernel": (
        "clear the table", "next batch's gathers and the probes",
        "near matrix and the batch's order", "inserts and the warp barrier",
        "mean, prune and emission")}
SEED_CLOCK_EDITS = (
    ("namespace {\n", "namespace {\n" + SEED_CLOCK_HEAD),
    # seed_block_kernel
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     + _CLK_INIT),
    ("  cluster.sync();   // the zeroed bins\n",
     "  cluster.sync();   // the zeroed bins\n  CLK(0);\n"),
    ("    for (int o = 0; __any_sync(kFull, o < m); ++o) {\n",
     "    CLK(1);\n    for (int o = 0; __any_sync(kFull, o < m); ++o) {\n"),
    ("          atomicAdd(dsum_r + x, (int)dsum_add);\n        }\n"
     "      }\n    }\n",
     "          atomicAdd(dsum_r + x, (int)dsum_add);\n        }\n"
     "      }\n    }\n    CLK(2);\n"),
    ("  if (!lead) return;\n",
     "  CLK(3);\n  if (!lead) {\n    CLK_SAVE();\n    return;\n  }\n"),
    ("      return;\n    }\n    if (tid == 0) {\n",
     "      CLK(4);\n      CLK_SAVE();\n      return;\n    }\n"
     "    if (tid == 0) {\n"),
    ("    last = best;\n  }\n}\n",
     "    last = best;\n  }\n  CLK(4);\n  CLK_SAVE();\n}\n"),
    # select_candidates_kernel
    ("  const int b = blockIdx.x, lane = threadIdx.x;\n",
     "  const int b = blockIdx.x, lane = threadIdx.x;\n" + _CLK_INIT),
    ("  for (int i = lane; i < slots; i += 32) table[i] = kEmpty;\n"
     "  __syncwarp();\n",
     "  for (int i = lane; i < slots; i += 32) table[i] = kEmpty;\n"
     "  __syncwarp();\n  CLK(0);\n"),
    ("    const unsigned sv = __ballot_sync(kFull, surv);\n",
     "    CLK(1);\n    const unsigned sv = __ballot_sync(kFull, surv);\n"),
    ("    // the kept insert themselves:",
     "    CLK(2);\n    // the kept insert themselves:"),
    ("    __syncwarp();   // the inserts before the next batch's probes\n",
     "    __syncwarp();   // the inserts before the next batch's probes\n"
     "    CLK(3);\n"),
    ("    frow[r] = 0.f;\n  }\n}\n",
     "    frow[r] = 0.f;\n  }\n  CLK(4);\n  CLK_SAVE();\n}\n"))


def clocked_seed_source(src: str) -> str:
    """``src`` (csrc/seed_mesh.cu) with the phase timers of
    SEED_CLOCK_EDITS and the C functions agc_read_clk (the eight sums of
    g_clk) and agc_reset_clk."""
    for text, new in SEED_CLOCK_EDITS:
        if src.count(text) != 1:
            raise ValueError(f"{src.count(text)} occurrences of {text!r}")
        src = src.replace(text, new)
    return src + SEED_CLOCK_TAIL


def seed_clock_lib():
    """The clocked copy of csrc/seed_mesh.cu, built once into the
    gitignored build directory and loaded with the committed build's
    signatures."""
    import ctypes
    from aligngraph2_tpu_torch.ops import _cuda
    from aligngraph2_tpu_torch.utils.nativebuild import BUILD_DIR
    if not hasattr(seed_clock_lib, "lib"):
        with open(_cuda.SEED_SRC) as f:
            src = clocked_seed_source(f.read())
        path = os.path.join(BUILD_DIR, "clock", "seed_mesh_clock.cu")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src)
        lib = _cuda.open_lib(path, {**_cuda.SEED_SIGNATURES,
                                    "agc_read_clk": [ctypes.c_void_p],
                                    "agc_reset_clk": []})
        seed_clock_lib.lib = lib
    return seed_clock_lib.lib


def phase_split(kernel, run):
    """One call of ``run`` (a call of a seeder kernel's wrapper) with the
    wrapper's library swapped for :func:`seed_clock_lib`: ({"threads",
    "cycles_per_thread", "cycles": {phase: cycles a thread}} of
    ``kernel``, the call's output)."""
    import ctypes
    import torch
    from aligngraph2_tpu_torch.ops import _cuda
    lib = seed_clock_lib()
    buf = (ctypes.c_ulonglong * 8)()
    _cuda.check(lib, lib.agc_reset_clk(), "clock reset")
    committed = _cuda.get_seed_lib
    _cuda.get_seed_lib = lambda: lib
    try:
        out = run()
    finally:
        _cuda.get_seed_lib = committed
    torch.cuda.synchronize()
    _cuda.check(lib, lib.agc_read_clk(ctypes.addressof(buf)), "clock read")
    n = max(buf[7], 1)
    cycles = {p: buf[k] / n for k, p in enumerate(SEED_PHASES[kernel])}
    return {"threads": buf[7], "cycles_per_thread": sum(cycles.values()),
            "cycles": cycles}, out


# clock64() phase timers for a copy of csrc/banded_adaptive.cu
# (adaptive_clock_lib): per form of a lane, (text, replacement) edits
# inside that form's function (each text found exactly once there).
# CLK(k) adds the thread's cycles since its last mark to phase k; thread
# 0 of lane 0 (warp 0 of the group past W = 1024) keeps its sums in
# g_clk[0 .. 8] and its rows in g_clk[15].
ADAPTIVE_CLOCK_HEAD = """
__device__ long long g_clk[16];
#define CLK(k) do { long long t_ = clock64(); clk_[k] += t_ - tp_; \\
                    tp_ = t_; } while (0)
"""
ADAPTIVE_CLOCK_TAIL = """
extern "C" int agc_read_clk(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(long long) * 16);
}
"""
_ACLK_INIT = "  long long clk_[9] = {}; long long tp_ = clock64();\n"
_ACLK_SAVE = ("  if (b == 0 && threadIdx.x == 0) {\n"
              "    for (int k_ = 0; k_ < 9; ++k_) g_clk[k_] = clk_[k_];\n"
              "    g_clk[15] = i;\n  }\n")
# each form: (its function's first line, the text after its end)
ADAPTIVE_CLOCK_REGIONS = {
    "dp_warp": ("__device__ __forceinline__ void dp_warp(",
                "__device__ __forceinline__ void dp_group("),
    "dp_group": ("__device__ __forceinline__ void dp_group(",
                 "dp_adaptive_kernel(AGC_DP_PARAMS) {")}
ADAPTIVE_PHASES = {
    "dp_warp": ("reduction issued; stage (every 32 rows)",
                "target compares, 3 drifts",
                "reduction's result, best cell, stop",
                "drift; eq and predecessor selects",
                "M and direction codes", "serial prefix",
                "shuffle scan and carry", "fix-up, keys",
                "stores, neighbour shuffles"),
    "dp_group": ("stage (every 32 rows), target compares",
                 "drift, predecessors, M and direction codes",
                 "own gap chain, keys, warp reduction",
                 "publish and the group's barrier",
                 "across the warps: carries, row best, fix-up, neighbours",
                 "best cell, stop, stores")}
ADAPTIVE_CLOCK_EDITS = {
    "dp_warp": (
        ("  int i = 0;         // the last row computed\n",
         "  int i = 0;         // the last row computed\n" + _ACLK_INIT),
        ("      qn = qx < NQ ? qrow[qx] : 0u;\n    }\n",
         "      qn = qx < NQ ? qrow[qx] : 0u;\n    }\n    CLK(0);\n"),
        ("qrep);\n    }\n", "qrep);\n    }\n    CLK(1);\n"),
        ("    ++i;\n", "    CLK(2);\n    ++i;\n"),
        ("    int M[C];\n", "    CLK(3);\n    int M[C];\n"),
        ("    // gap chain: serial prefix",
         "    CLK(4);\n    // gap chain: serial prefix"),
        ("    int x = H[C - 1];\n", "    CLK(5);\n    int x = H[C - 1];\n"),
        ("    const int p0 = base + 1 + j0;\n",
         "    CLK(6);\n    const int p0 = base + 1 + j0;\n"),
        ("    if (stop) {", "    CLK(7);\n    if (stop) {"),
        ("    row_reduce<C, PACKED>(H, key, j0, ra, rb);\n  }\n  cp_async",
         "    CLK(8);\n    row_reduce<C, PACKED>(H, key, j0, ra, rb);\n"
         "  }\n  cp_async"),
        ("  cp_async_wait<0>();   // no copy outlives the warp\n",
         "  cp_async_wait<0>();   // no copy outlives the warp\n"
         + _ACLK_SAVE)),
    "dp_group": (
        ("  int i = 0;                // the last row computed\n",
         "  int i = 0;                // the last row computed\n"
         + _ACLK_INIT),
        ("    ++i;   // row i", "    CLK(0);\n    ++i;   // row i"),
        ("    // the warp's own gap chain",
         "    CLK(1);\n    // the warp's own gap chain"),
        ("    int* pub = s_pub", "    CLK(2);\n    int* pub = s_pub"),
        ("every warp's part published\n",
         "every warp's part published\n    CLK(3);\n"),
        ("    if (rmax > best) {", "    CLK(4);\n    if (rmax > best) {"),
        ("    if (stop) {", "    CLK(5);\n    if (stop) {"),
        ("  cp_async_wait<0>();   // no copy outlives the block\n",
         "  cp_async_wait<0>();   // no copy outlives the block\n"
         + _ACLK_SAVE))}


def clocked_adaptive_source(src: str) -> str:
    """``src`` (csrc/banded_adaptive.cu) with the phase timers of
    ADAPTIVE_CLOCK_EDITS, each form's inside its own function, and the C
    function agc_read_clk (the 16 values of g_clk)."""
    if src.count("namespace {\n") != 1:
        raise ValueError("no single anonymous namespace")
    src = src.replace("namespace {\n", "namespace {\n" + ADAPTIVE_CLOCK_HEAD)
    for form, (first, after) in ADAPTIVE_CLOCK_REGIONS.items():
        a = src.index(first)
        e = src.index(after, a + len(first))
        part = src[a:e]
        for text, new in ADAPTIVE_CLOCK_EDITS[form]:
            if part.count(text) != 1:
                raise ValueError(f"{part.count(text)} occurrences of "
                                 f"{text!r} in {form}")
            part = part.replace(text, new)
        src = src[:a] + part + src[e:]
    return src + ADAPTIVE_CLOCK_TAIL


def adaptive_clock_lib():
    """The clocked copy of csrc/banded_adaptive.cu, built once into the
    gitignored build directory and loaded with the committed build's
    signatures."""
    import ctypes
    from aligngraph2_tpu_torch.ops import _cuda
    from aligngraph2_tpu_torch.utils.nativebuild import BUILD_DIR
    if not hasattr(adaptive_clock_lib, "lib"):
        with open(_cuda.ADAPTIVE_SRC) as f:
            src = clocked_adaptive_source(f.read())
        path = os.path.join(BUILD_DIR, "clock", "banded_adaptive_clock.cu")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(src)
        adaptive_clock_lib.lib = _cuda.open_lib(path, {
            **_cuda.ADAPTIVE_SIGNATURES, "agc_read_clk": [ctypes.c_void_p]})
    return adaptive_clock_lib.lib


def adaptive_phase_split(W, run):
    """One call of ``run`` (a call of banded_align) with the wrapper's
    library swapped for :func:`adaptive_clock_lib`: ({"lane0_rows",
    "cycles_per_row", "cycles": {phase: cycles a row}} of lane 0's first
    thread, the call's output)."""
    import ctypes
    import torch
    from aligngraph2_tpu_torch.ops import _cuda
    lib = adaptive_clock_lib()
    committed = _cuda.get_adaptive_lib
    _cuda.get_adaptive_lib = lambda: lib
    try:
        out = run()
    finally:
        _cuda.get_adaptive_lib = committed
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * 16)()
    _cuda.check(lib, lib.agc_read_clk(ctypes.addressof(buf)), "clock read")
    rows = max(buf[15], 1)
    phases = ADAPTIVE_PHASES["dp_group" if W > 1024 else "dp_warp"]
    cycles = {p: buf[k] / rows for k, p in enumerate(phases)}
    return {"lane0_rows": buf[15], "cycles_per_row": sum(cycles.values()),
            "cycles": cycles}, out


def seed_bounds(arrays, kw):
    """Least time of seed_block_kernel's function on these inputs, and
    the kernel's latency model: (bound ms, its kind, latency ms, hits).
    Bytes: both strands' read bytes and the lengths, the blocks' codes
    read once, a position a hit (only a hit reads one), cnt and diag
    written.  Operations, the least
    work: a rolling code a valid position (SEED_CODE_OPS), each block's
    codes into a hash table of (lo, n) and each valid position's probe of
    each block's table (SEED_HASH_OPS each), SEED_HIT_OPS a hit, and one
    top-T pass over the touched bins (SEED_BIN_OPS a bin), hits and bins
    counted here from this run's data.  Latency, the kernel's design: a
    block's positions a thread (its slice of NK / C positions over
    its threads), each its k byte loads (one L1 hit), the directory's
    pair and the range's first code (two L2 reads) and the rest of the
    range's search (an L1 hit), times the waves of blocks the card holds
    (four an SM at most, fewer where the shared memory is short; the bins
    in the scratch take none) on this card's SMs."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.ops.kmer import kmer_codes_batch
    from aligngraph2_tpu_torch.parallel import sharded
    q_fwd, q_rev, lens, sc, sp = arrays
    B, NQ = q_fwd.shape
    NB, L = sc.shape
    k, nbins, T = kw["k"], kw["nbins"], kw["top_t"]
    NK = NQ - k + 1
    qpos = torch.arange(NK, device=sc.device)
    hits = touched = valid = 0
    for q in (q_fwd, q_rev):
        qc, qv = kmer_codes_batch(q, lens, k)
        valid += int(qv.sum())
        rows = torch.arange(B, device=sc.device)[:, None] * nbins
        for b in range(NB):
            lo = torch.searchsorted(sc[b], qc)
            n = torch.searchsorted(sc[b], qc, right=True) - lo
            ok = qv & (n > 0) & (n <= kw["max_occ"])
            hits += int(torch.where(ok, n.clamp(max=kw["occ"]), 0).sum())
            keys = []
            for o in range(kw["occ"]):
                hit = ok & (o < n)
                diag = sp[b][(lo + o).clamp(max=L - 1)] - qpos + NQ
                x = (diag // kw["bin_w"]).clamp(0, nbins - 1)
                keys.append((rows + x)[hit])
            touched += int(torch.cat(keys).unique().numel())
    nbytes = (2 * B * NQ + 4 * B + NB * L * 4 + hits * 4
              + B * 2 * NB * T * 8)
    ops = (valid * SEED_CODE_OPS + (NB * L + valid * NB) * SEED_HASH_OPS
           + hits * SEED_HIT_OPS + touched * SEED_BIN_OPS)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = bytes_bound_ms(nbytes)
    sms = torch.cuda.get_device_properties(sc.device).multi_processor_count
    C = sharded.seed_grid(NB, 2 * B, NK, sms)
    threads = sharded.SEED_THREADS
    smem = (0 if sharded.seed_bins_in_scratch(nbins)
            else sharded.seed_smem_bytes(nbins))
    per_sm = min(2048 // threads, SM_SHARED_BYTES // (
        smem + 1024 + 232448 - sharded.SEED_SMEM_MAX))
    position = L1_HIT_CYCLES + 2 * L2_HIT_CYCLES + L1_HIT_CYCLES
    lat_ms = (-(-C * 2 * B * NB // (sms * per_sm))
              * -(-(-(-NK // C)) // threads) * position
              / SM_CLOCK_HZ * 1e3)
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", lat_ms, hits)


def synthetic_index(rng, blocks, BL, overlap, k):
    """A random genome of ``blocks`` blocks of BL bases at the mesh's
    overlap, made from ``rng``, and its block index sorted on the card as
    build_block_index sorts it (stable by code): (genome codes on the host,
    sorted_codes, sorted_pos)."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.ops.kmer import kmer_codes_batch
    stride = BL - overlap
    genome = rng.integers(0, 4, (blocks - 1) * stride + BL, dtype=np.uint8)
    g = torch.from_numpy(genome).cuda()
    codes, _ = kmer_codes_batch(
        g.unfold(0, BL, stride).contiguous(),
        torch.full((blocks,), BL, dtype=torch.int32, device=g.device), k)
    del g
    sc, sp = torch.sort(codes, dim=1, stable=True)
    del codes
    return genome, sc, sp.int()


def seed_gate_shapes(index, k, reads, ctgs, seed):
    """The seed gate's inputs on the card, one per SEED_GATE shape: (shape,
    (q_fwd, q_rev, lens, sorted_codes, sorted_pos, seed_dir), kw).  Reads:
    the first B reads of the mesh run's bucket at NQ 8192 and 16384, B
    mutated contig pieces of 60-131 kb at NQ 131072, all on the mesh
    run's block index (``index``, k-mer size ``k``); and B mutated pieces
    of 4-8 kb of the synthetic genome (:func:`synthetic_index`) on its
    index; each beside its reverse complement."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.io.seqdb import (decode_seq, encode_seq,
                                                revcomp_codes)
    from aligngraph2_tpu_torch.parallel.sharded import seed_directory
    from tests.synth import mutate

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 3)
    mesh_index = (torch.from_numpy(index.sorted_codes).to(dev),
                  torch.from_numpy(index.sorted_pos).to(dev))
    for B, NQ, bin_w, blocks, block_len in SEED_GATE:
        sc, sp = mesh_index
        BL = block_len or index.block_len
        if blocks:
            genome, sc, sp = synthetic_index(
                rng, blocks, BL, BL // 4 if block_len else index.overlap, k)
            seqs = []
            for _ in range(B):
                n = int(rng.integers(NQ // 2, NQ - 200))
                at = int(rng.integers(0, len(genome) - n))
                seqs.append(encode_seq(mutate(
                    rng, decode_seq(genome[at:at + n]), 0.05, 0.01,
                    0.01))[:NQ])
            del genome
        elif NQ <= 16384:
            seqs = [reads.get_codes(r) for r in range(len(reads))
                    if NQ // 2 < reads.size(r) <= NQ][:B]
        else:
            seqs = []
            for s in range(B):
                src = ctgs.get_str(s % len(ctgs))
                n = min(int(rng.integers(60000, NQ - 2000)), len(src))
                at = int(rng.integers(0, len(src) - n + 1))
                piece = mutate(rng, src[at:at + n], 0.02, 0.01, 0.01)[:NQ]
                seqs.append(encode_seq(piece))
        if len(seqs) < B:
            raise SystemExit(f"seed_gate: {len(seqs)} reads of the "
                             f"{NQ} bucket, {B} wanted")
        q_fwd = np.zeros((B, NQ), np.uint8)
        q_rev = np.zeros((B, NQ), np.uint8)
        lens = np.zeros(B, np.int32)
        for r, c in enumerate(seqs):
            q_fwd[r, :len(c)] = c
            q_rev[r, :len(c)] = revcomp_codes(c)
            lens[r] = len(c)
        nbins = int(np.ceil((BL + NQ) / bin_w)) + 2
        kw = dict(k=k, NQ=NQ, nbins=nbins, bin_w=bin_w, occ=SEED_OCC,
                  max_occ=SEED_MAX_OCC, top_t=8)
        yield ((B, NQ, bin_w, blocks, BL),
               tuple(torch.from_numpy(x).to(dev) for x in (q_fwd, q_rev, lens))
               + (sc, sp, seed_directory(sc, k)), kw)


def seed_gate(index, k, reads, ctgs, seed, regs) -> dict:
    """seed_block_kernel against its plain version (both strands' k-mer
    codes, then _seed_block_candidates_ref) on the card, at each SEED_GATE
    shape (:func:`seed_gate_shapes`); cnt and diag exact, also from the
    clocked copy, whose cycles a thread by phase (:func:`phase_split`)
    are in the line.  Prints a line per shape; returns the timings at the
    first."""
    import torch
    from aligngraph2_tpu_torch.parallel import sharded

    timing = {}
    for (B, NQ, bin_w, blocks, BL), arrays, kw in seed_gate_shapes(
            index, k, reads, ctgs, seed):
        plain_ms, want = warm_ms(
            lambda: sharded._seed_reads_ref(*arrays[:5], **kw), PLAIN_REPS)
        got = sharded.seed_block(*arrays, **kw)
        split, clocked = phase_split(
            "seed_block_kernel", lambda: sharded.seed_block(*arrays, **kw))
        bad = [name for name, w, g in zip(("cnt", "diag"), want, got)
               if not torch.equal(w, g)]
        bad += [f"clocked {name}" for name, w, g in zip(
            ("cnt", "diag"), want, clocked) if not torch.equal(w, g)]
        ms = cuda_ms(lambda: sharded.seed_block(*arrays, **kw), REPS)
        bound, by, lat, hits = seed_bounds(arrays[:5], kw)
        NB, L = arrays[3].shape
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        emit({"phase": "seed_gate", "B": B, "streams": 2 * B, "NQ": NQ,
              "bin_w": bin_w, "blocks": NB, "block_len": BL, "L": L,
              "nbins": kw["nbins"],
              "cluster": sharded.seed_grid(NB, 2 * B, NQ - kw["k"] + 1,
                                           sms),
              "bins_in": ("scratch" if sharded.seed_bins_in_scratch(
                  kw["nbins"]) else "shared memory"),
              "launches": -(-NB // sharded.seed_launch_blocks(
                  NB, 2 * B, kw["nbins"])),
              "bin_bytes": sharded.seed_smem_bytes(kw["nbins"]),
              "hits": hits, "nonzero_candidates": int((got[0] > 0).sum()),
              "exact": not bad, "mismatch": bad, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
              "latency_model_ms": lat, "phase_split": split,
              "regs": regs.get("seed_block_kernel")})
        if bad:
            raise SystemExit(f"seed_gate failed at B={B} NQ={NQ} "
                             f"bin_w={bin_w} blocks={NB}: {bad}")
        if not timing:
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "err": 0}
        del arrays, want, got
    return timing


def planted_select_cases() -> dict:
    """The dedup table's edges, made from a fixed seed: name -> ((cnt,
    tid (N,), gdiag), keyword arguments).  ``half-circle``: pairs exactly
    2^31 apart on one target (|INT_MIN| = INT_MIN is near).
    ``short-bucket``: bin_w = 84, so 2^32 mod 85 = 1 and the circle's
    last bucket holds gdiag -1 alone; row 0 keeps -1 and then meets 5,
    which only the last bucket's probe finds; the rows spread around 0
    and +-2^31.  ``two-targets``: targets 1 and 2 at the same diagonals.
    ``burst``: equal counts, so the batches are the enumeration: 40
    near-equal diagonals on one target (row 0), a chain 50 apart where
    every other one is kept (row 1), and random rows."""
    import numpy as np
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(17)
    kw = dict(alpha=0.5, beta=2.0, bin_w=64, min_hits=1, prune=0.0)
    out = {}
    B, N = 6, 80
    cnt = rng.integers(5, 9, (B, N)).astype(np.int32)
    cnt[:, N // 2:] -= 4   # the partners: lower counts, later batches
    tid = np.tile(rng.choice(np.array([1, -1, 2], np.int32), N // 2), 2)
    g = rng.integers(-3000, 3000, (B, N // 2))
    gdiag = np.concatenate([g, g + (1 << 31)], 1).astype(np.int64)
    gdiag = ((gdiag + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
    out["half-circle"] = ((cnt, tid, gdiag), dict(kw, K=80))
    B, N = 6, 96
    cnt = rng.integers(0, 20, (B, N)).astype(np.int32)
    tid = rng.choice(np.array([1, 2], np.int32), N)
    gdiag = rng.integers(-200, 200, (B, N)).astype(np.int32)
    gdiag[2:4] = i32.min + rng.integers(0, 200, (2, N))
    gdiag[2:4, ::2] = i32.max - rng.integers(0, 200, (2, N // 2))
    gdiag[0, tid == 1] = 400   # out of the way
    a, b = np.flatnonzero(tid == 1)[:2]
    cnt[0, a], gdiag[0, a] = 30, -1
    cnt[0, b], gdiag[0, b] = 1, 5   # a later batch
    out["short-bucket"] = ((cnt, tid, gdiag), dict(kw, K=40, bin_w=84))
    B, N = 4, 64
    c = rng.integers(1, 9, (B, N // 2)).astype(np.int32)
    tid = np.repeat(np.array([1, 2], np.int32), N // 2)
    g = rng.integers(0, 5000, (B, N // 2)).astype(np.int32)
    out["two-targets"] = ((np.concatenate([c, c], 1), tid,
                           np.concatenate([g, g], 1)), dict(kw, K=64))
    B, N = 4, 100
    cnt = np.full((B, N), 5, np.int32)
    tid = np.ones(N, np.int32)
    tid[60:] = rng.choice(np.array([3, -3], np.int32), N - 60)
    gdiag = rng.integers(0, 4000, (B, N)).astype(np.int32)
    gdiag[0, :40] = rng.integers(0, 40, 40)
    gdiag[1, :60] = np.arange(60) * 50
    out["burst"] = ((cnt, tid, gdiag), dict(kw, K=64))
    return out


def select_inputs(rng, B, N):
    """cnt, tid, gdiag for B reads of N candidates: counts from [0, 40)
    (planted ties), six targets on both strands; by row r mod 4: nearby
    diagonals (heavy dedup, rows 0 and 1; in rows 1 target -1 has a
    diagonal -1 of count 40, (tid, gdiag) = (-1, -1) being the one entry
    the kernel's table keeps apart, and five more near it), diagonals
    spread over 2^30 (a kept list of nearly every candidate: row 2), and
    target 1's diagonals at +-2^31, where the int32 difference wraps
    (row 3)."""
    import numpy as np
    cnt = rng.integers(0, 40, (B, N)).astype(np.int32)
    tid = rng.choice(np.array([-3, -2, -1, 1, 2, 3], np.int32), N)
    gdiag = rng.integers(0, 20000, (B, N)).astype(np.int32)
    gdiag[2::4] = rng.integers(0, 1 << 30, (len(range(2, B, 4)), N))
    one = np.flatnonzero(tid == 1)
    half = len(one) // 2
    for r in range(3, B, 4):
        gdiag[r, one[:half]] = np.iinfo(np.int32).max - rng.integers(
            0, 300, half)
        gdiag[r, one[half:]] = np.iinfo(np.int32).min + rng.integers(
            0, 300, len(one) - half)
    neg = np.flatnonzero(tid == -1)[:6]
    for r in range(1, B, 4):
        cnt[r, neg[0]], gdiag[r, neg[0]] = 40, -1
        gdiag[r, neg[1:]] = -1 + rng.integers(-100, 100, len(neg) - 1)
    return cnt, tid, gdiag


def select_bounds(cnt, order_kept, kw):
    """Least time of select_candidates_kernel's function on these inputs,
    and the kernel's latency model: (bound ms, its kind, latency ms,
    largest kept list).  ``order_kept``: (B, N) bool, the dedup's kept
    flags in the stable count order (the plain version's, before the
    prune).  Bytes: cnt, gdiag and tid read once, sel, idx and score
    written.  Operations, the least work: SELECT_OPS a candidate, and a
    table of the kept entries by (tid, gdiag // (bin_w + 1)), which holds
    at most one kept entry a bucket and a tid, so a candidate past
    min_hits probes four buckets (its own, the two beside it, and the
    one 2^31 away, since |INT_MIN| stays INT_MIN) and a kept one adds
    itself (SELECT_PROBE_OPS each).  Latency, the kernel's design: the
    slowest read's batches of 32 that hold a candidate past min_hits,
    each a probe and an insert (a shared step, or an L2 read where the
    table is in the scratch) and the near matrix (SELECT_MATRIX_CYCLES)."""
    import torch
    from aligngraph2_tpu_torch.parallel import sharded
    B, N = cnt.shape
    valid = torch.sort(cnt, dim=1, descending=True, stable=True).values \
        >= kw["min_hits"]
    nbytes = B * N * 8 + N * 4 + B * kw["K"] * 9
    ops = (B * N * SELECT_OPS + (4 * int(valid.sum())
                                 + int(order_kept.sum())) * SELECT_PROBE_OPS)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = bytes_bound_ms(nbytes)
    pad = -N % 32
    batches = torch.nn.functional.pad(valid, (0, pad)).view(B, -1, 32) \
        .any(2).sum(1)
    step = (SHARED_STEP_CYCLES if sharded.select_slots(N)
            <= sharded.SELECT_SHARED_SLOTS else L2_HIT_CYCLES)
    cycles = batches * (2 * step + SELECT_MATRIX_CYCLES)
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes",
            int(cycles.max()) / SM_CLOCK_HZ * 1e3,
            int(order_kept.sum(1).max()))


def select_gate(seed, kw, regs) -> dict:
    """select_candidates_kernel against its plain version on the card:
    first on :func:`planted_select_cases`, then at B = SELECT_GATE_B and
    each N of SELECT_GATE_N, on select_inputs, with the mesh aligner's K,
    min_hits, alpha, beta, bin_w and prune (``kw``); sel, idx and score
    exact, also from the clocked copy, whose cycles by phase
    (:func:`phase_split`) are in the line; past N = 8192 the table is in
    the scratch (``in_scratch``).  Beside the wrapper's time, that of its
    stable torch.sort alone (``sort_ms``).  The wrapper's time must grow
    at most 4x from N = 12,800 to 32,768 (2.56x is linear).  Prints a
    line per case and per N; returns the timings at the first N."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.parallel import sharded

    for name, (case, case_kw) in planted_select_cases().items():
        arrays = tuple(torch.from_numpy(x).cuda() for x in case)
        want = sharded._select_read_candidates_ref(*arrays, **case_kw)
        got = sharded.select_candidates(*arrays, **case_kw)
        bad = [what for what, w, g in zip(("sel", "idx", "score"), want,
                                          got) if not torch.equal(w, g)]
        emit({"phase": "select_gate", "case": name, "B": case[0].shape[0],
              "N": case[0].shape[1], "bin_w": case_kw["bin_w"],
              "selected": int(want[0].sum()), "exact": not bad,
              "mismatch": bad})
        if bad:
            raise SystemExit(f"select_gate failed on {name}: {bad}")
    rng = np.random.default_rng(seed + 4)
    timing, by_n = {}, {}
    for N in SELECT_GATE_N:
        arrays = tuple(torch.from_numpy(x).cuda()
                       for x in select_inputs(rng, SELECT_GATE_B, N))
        plain_ms, want = warm_ms(
            lambda: sharded._select_read_candidates_ref(*arrays, **kw),
            PLAIN_REPS)
        got = sharded.select_candidates(*arrays, **kw)
        split, clocked = phase_split(
            "select_candidates_kernel",
            lambda: sharded.select_candidates(*arrays, **kw))
        bad = [name for name, w, g in zip(("sel", "idx", "score"), want, got)
               if not torch.equal(w, g)]
        bad += [f"clocked {name}" for name, w, g in zip(
            ("sel", "idx", "score"), want, clocked) if not torch.equal(w, g)]
        ms = cuda_ms(lambda: sharded.select_candidates(*arrays, **kw), REPS)
        by_n[N] = ms
        cnt = arrays[0]
        sort_ms = cuda_ms(lambda: torch.sort(-cnt, dim=1, stable=True), REPS)
        # every kept entry before the prune, in order: the dedup's work
        every = sharded._select_read_candidates_ref(
            *arrays, **dict(kw, K=N, prune=0.0))
        order = torch.sort(-cnt, dim=1, stable=True).indices
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(N, device=cnt.device).expand(
            SELECT_GATE_B, N).contiguous())
        at = torch.where(every[0], rank.gather(1, every[1].long()), N)
        kept = torch.zeros((SELECT_GATE_B, N + 1), dtype=torch.bool,
                           device=cnt.device).scatter_(1, at, True)[:, :N]
        bound, by, lat, most = select_bounds(cnt, kept, kw)
        slots = sharded.select_slots(N)
        emit({"phase": "select_gate", "B": SELECT_GATE_B, "N": N,
              "selected": int(want[0].sum()), "most_kept": most,
              "table_slots": slots,
              "in_scratch": slots > sharded.SELECT_SHARED_SLOTS,
              "exact": not bad, "mismatch": bad,
              "ms": ms, "sort_ms": sort_ms, "plain_ms": plain_ms,
              "bound_ms": bound, "bound_by": by, "latency_model_ms": lat,
              "phase_split": split,
              "regs": regs.get("select_candidates_kernel")})
        if bad:
            raise SystemExit(f"select_gate failed at N={N}: {bad}")
        if not timing:
            timing = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "err": 0}
    growth = by_n[32768] / by_n[12800]
    emit({"phase": "select_gate", "growth_12800_to_32768": growth})
    if growth > 4:
        raise SystemExit(f"select_gate: {growth:.2f}x from N = 12,800 to "
                         f"32,768, over 4x")
    return timing


def mesh(args, regs, reads, ctgs, mesh_cpu) -> tuple:
    """Read -> contig for every read of the stage dataset through the mesh
    path on a 1x1 mesh of the card, which must launch each adaptive
    kernel and each seeder kernel, no static-band kernel and no plain
    version on the card; the CPU's records of the first MESH_CPU_READS
    (the future ``mesh_cpu`` of :func:`mesh_on_cpu`) must equal the
    card's.  Then the seeder's kernels against their plain versions
    (:func:`seed_gate`, :func:`select_gate`) on the run's block index and
    settings.  Returns the adaptive kernels' launches, the seeder
    kernels', the two gates' timings and the run's .ref text."""
    import torch
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.align.records import AlignmentSet
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.ops import banded_static as bs
    from aligngraph2_tpu_torch.parallel.mesh import make_mesh

    n = len(reads)
    zero_launches()
    with MeshCalls() as mc, RefCalls() as rc:
        t0 = time.perf_counter()
        al = LongReadAligner(ctgs, AlignerConfig(), mesh=make_mesh(1))
        al._ensure_sharded_index()
        torch.cuda.synchronize()
        index_s = time.perf_counter() - t0
        alns = al.align_reads(reads, ids=range(n))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = adaptive_launches()
    s_launches = seed_launches()
    static = bs.banded_dp_static.launches + bs.traceback_static.launches
    idx = al._block_index
    index_bytes = sum(t.numel() * t.element_size()
                      for field in al._dev_index for t in field.flat)
    few = {reads.names[r] for r in range(min(MESH_CPU_READS, n))}
    card_text = AlignmentSet([a for a in alns if a.query_name in few]
                             ).to_ref_text()
    cpu_text, cpu_s = mesh_cpu.result()
    by_fn = {}
    for name, replaces in MESH_FUNCTIONS.items():
        st = mc.stats[name]
        calls = max(st["calls"], 1)
        by_fn[name] = {"replaces": replaces, "calls": st["calls"],
                       "ms_per_call": st["ms"] / calls,
                       "bytes_per_call": st["bytes"] / calls,
                       "bound_ms_per_call": bytes_bound_ms(
                           st["bytes"] / calls), "bound_by": "bytes"}
    aligned = len({a.query_name for a in alns})
    split = extender_split(mc)
    s_split = seeder_split(mc)
    emit({"phase": "mesh", "mesh": al.mesh.shape,
          "device": str(al.mesh.devices[0, 0]), "reads": n,
          "read_bp": int(sum(reads.size(r) for r in range(n))),
          "wall_s": wall, "reads_per_s": n / wall, "index_s": index_s,
          "blocks": int((idx.block_lens > 0).sum()),
          "blocks_padded": len(idx.block_lens), "block_len": idx.block_len,
          "index_device_bytes": index_bytes, "lanes": mc.lanes,
          "alignments": len(alns), "aligned_reads": aligned,
          "static_launches": static, "adaptive_launches": launches,
          "seeder_launches": s_launches,
          "plain_calls_on_card": rc.cuda_calls,
          "seeder_calls": mc.stats["_seed_body"]["calls"],
          "seeder_ms_per_call": by_fn["_seed_body"]["ms_per_call"],
          "seeder_split": s_split,
          "extender_calls": mc.stats["_extend_body"]["calls"],
          "extender_ms_per_call": by_fn["_extend_body"]["ms_per_call"],
          "extender_split": split,
          "by_function": by_fn, "cpu_reads": len(few),
          "cpu_ref_text_equal": card_text == cpu_text,
          "cpu_alignments": card_text.count("\n") // 3, "cpu_s": cpu_s})
    if card_text != cpu_text or not card_text:
        raise SystemExit("mesh: the card's and the CPU's .ref text differ "
                         "on the first reads, or no alignment")
    if static:
        raise SystemExit("mesh: the mesh path launched a static-band kernel")
    if not all({**launches, **s_launches}.values()) or rc.cuda_calls:
        raise SystemExit(f"mesh: a kernel never ran ({launches}, "
                         f"{s_launches}) or a plain version ran on the "
                         f"card ({rc.cuda_calls} calls)")
    if aligned < 0.8 * n:
        raise SystemExit("mesh: fewer than 80% of reads aligned")
    check_records(alns, reads, ctgs)
    cfg = al.cfg
    seed_t = seed_gate(idx, cfg.seed_k, reads, ctgs, args.seed, regs)
    select_t = select_gate(args.seed, dict(
        K=cfg.max_candidates, min_hits=cfg.min_block_hits, alpha=cfg.alpha,
        beta=cfg.beta, bin_w=max(cfg.band_width // 2, 32),
        prune=cfg.prune_ratio), regs)
    return launches, s_launches, seed_t, select_t, alns.to_ref_text()


def widths_mesh_on_cpu(seed):
    """The first MESH_CPU_READS reads of the pipeline phase's dataset
    through the mesh path on a 1x1 mesh of the CPU at WIDTHS_MESH, to the
    similar genome: (.ref text, wall s).  Runs in a child process."""
    import torch
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    from aligngraph2_tpu_torch.parallel.mesh import make_mesh
    from tests.synth import make_dataset

    torch.set_num_threads(1)
    ds = make_dataset(seed=seed, **PIPELINE_DATA)
    reads = SeqDatabase(ds["reads"])
    t0 = time.perf_counter()
    alns = LongReadAligner(
        SeqDatabase(ds["similar"]), AlignerConfig(**WIDTHS_MESH),
        mesh=make_mesh(devices=[torch.device("cpu")])).align_reads(
            reads, ids=range(min(MESH_CPU_READS, len(reads))))
    return alns.to_ref_text(), time.perf_counter() - t0


# the kernels by name, as the profiler reports them (the template
# arguments, W and the bins' place, kept)
KERNEL_NAME = re.compile(r"((?:dp|tb)_(?:static|adaptive)_kernel|"
                         r"seed_block_kernel|select_candidates_kernel)"
                         r"(<[^>]*>)?")


def all_launches() -> dict:
    from aligngraph2_tpu_torch.ops import banded_static as bs
    return {"banded_dp_static": bs.banded_dp_static.launches,
            "traceback_static": bs.traceback_static.launches,
            **adaptive_launches(), **seed_launches()}


def kernel_split(work) -> dict:
    """``work`` run again under torch.profiler: {kernel with its template
    arguments: {"launches", "ms_per_launch"}} of the port's kernels, card
    time.  A few small kernels run first inside the profiler: it missed
    the first launches of a session without them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x = torch.ones(1 << 20, device="cuda")
        for _ in range(8):
            x.add_(1)
        torch.cuda.synchronize()
        work()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = KERNEL_NAME.search(e.key)
        if e.device_type == DeviceType.CUDA and m:
            d = out.setdefault(m.group(0).replace(" ", ""),
                               {"launches": 0, "ms": 0.0})
            d["launches"] += e.count
            d["ms"] += e.self_device_time_total / 1e3
    return {k: {"launches": v["launches"],
                "ms_per_launch": v["ms"] / max(v["launches"], 1)}
            for k, v in out.items()}


def widths(args, widths_cpu) -> dict:
    """The port's entry points at the band widths and bin counts past the
    default ones, on the card's kernels: (a) LongReadAligner at band_width
    WIDTHS_BAND, read -> contig for the stage dataset's first WIDTHS_READS
    reads (the static band at W = 2048) and the long read (the adaptive
    band at 2048), each .ref text equal to the same run through the plain
    versions on the card; (b) the mesh path on a 1x1 mesh of the card at
    WIDTHS_MESH, WIDTHS_READS reads of the pipeline phase's dataset to its
    similar genome (the seeder's bins in the scratch, the extender at W =
    32), the first MESH_CPU_READS equal to the CPU's (the future
    ``widths_cpu`` of :func:`widths_mesh_on_cpu`).  Every launch count is
    zeroed before each run and read after it; no plain version may run on
    the card there.  A line per run: reads, reads/s, wall, launches, and
    each kernel's launches and card ms a launch, by name with W (or the
    seeder's bins' place) from a profiled rerun.  Returns the launches of
    the three runs summed."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner, _bucket
    from aligngraph2_tpu_torch.align.records import AlignmentSet
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    from aligngraph2_tpu_torch.parallel.mesh import make_mesh
    from tests.synth import make_dataset

    total = dict.fromkeys(all_launches(), 0)

    def run(name, work, n_reads, need, extra):
        zero_launches()
        with RefCalls() as rc:
            t0 = time.perf_counter()
            alns = work()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = all_launches()
        for k, v in launches.items():
            total[k] += v
        line = {"phase": "widths", "run": name, "reads": n_reads,
                "wall_s": wall, "reads_per_s": n_reads / wall,
                "alignments": len(alns),
                "aligned_reads": len({a.query_name for a in alns}),
                "launches": launches, "plain_calls_on_card": rc.cuda_calls,
                "kernels": kernel_split(work), **extra(alns)}
        line["equal"] = bool(line.pop("equal_", True))
        emit(line)
        missing = [k for k in need if not launches[k]]
        if missing or rc.cuda_calls or not line["equal"] or not len(alns):
            raise SystemExit(f"widths {name}: kernels not launched "
                             f"{missing}, {rc.cuda_calls} plain calls on "
                             f"the card, equal {line['equal']}, "
                             f"{len(alns)} alignments")
        return alns

    # (a) one device, band_width WIDTHS_BAND
    ds = stage_dataset(args.seed, args.genome_mb)
    reads, ctgs = SeqDatabase(ds["reads"]), SeqDatabase(ds["contigs"])
    cfg = AlignerConfig(band_width=WIDTHS_BAND)
    ids = range(min(WIDTHS_READS, len(reads)))

    def plain_equal(target, rdb, rids):
        def extra(alns):
            t0 = time.perf_counter()
            plain = LongReadAligner(target, cfg, plain=True).align_reads(
                rdb, ids=rids)
            torch.cuda.synchronize()
            return {"plain_s": time.perf_counter() - t0,
                    "equal_": alns.to_ref_text() == plain.to_ref_text()}
        return extra

    alns = run("static", lambda: LongReadAligner(ctgs, cfg).align_reads(
        reads, ids=ids), len(ids), ("banded_dp_static", "traceback_static"),
        plain_equal(ctgs, reads, ids))
    check_records(alns, reads, ctgs)
    lr_reads, lr_target = long_read_dbs(args.seed)
    alns = run("long_read", lambda: LongReadAligner(
        lr_target, cfg).align_reads(lr_reads), 1,
        ("banded_align", "traceback"),
        plain_equal(lr_target, lr_reads, None))
    check_records(alns, lr_reads, lr_target)

    # (b) the mesh path, band_width 32 on 1 Mb blocks
    t0 = time.perf_counter()
    ds = make_dataset(seed=args.seed, **PIPELINE_DATA)
    reads, sim = SeqDatabase(ds["reads"]), SeqDatabase(ds["similar"])
    setup_s = time.perf_counter() - t0
    cfg_m = AlignerConfig(**WIDTHS_MESH)
    al = LongReadAligner(sim, cfg_m, mesh=make_mesh(1))
    al._ensure_sharded_index()
    ids = range(min(WIDTHS_READS, len(reads)))
    few = {reads.names[r] for r in range(min(MESH_CPU_READS, len(reads)))}
    idx = al._block_index
    nq = sorted({_bucket(reads.size(r)) for r in ids})

    def mesh_extra(alns):
        from aligngraph2_tpu_torch.parallel import sharded
        card = AlignmentSet([a for a in alns if a.query_name in few]
                            ).to_ref_text()
        cpu_text, cpu_s = widths_cpu.result()
        bins = {n: int(np.ceil((idx.block_len + n) / max(
            cfg_m.band_width // 2, 32))) + 2 for n in nq}
        return {"setup_s": setup_s, "blocks": int((idx.block_lens > 0).sum()),
                "block_len": idx.block_len, "nbins_by_nq": bins,
                "bins_in_scratch": {n: sharded.seed_bins_in_scratch(b)
                                    for n, b in bins.items()},
                "cpu_reads": len(few), "cpu_s": cpu_s,
                "equal_": bool(card) and card == cpu_text}

    alns = run("mesh", lambda: al.align_reads(reads, ids=ids), len(ids),
               ("banded_align", "traceback", "seed_block",
                "select_candidates"), mesh_extra)
    check_records(alns, reads, sim)
    return total


class CardLaunches:
    """Each kernel's launches by card while open: {kernel: {card: n}}.
    Every wrapper asks ``_cuda.launch_target`` for its card before it
    launches and hands each launch's return code to ``_cuda.check``
    (KERNEL_OF_LAUNCH names the kernel); both are module attributes,
    which is what is replaced here, so a launch counts on the card it
    ran on once it succeeded.  No package file changes."""

    def __enter__(self):
        from aligngraph2_tpu_torch.ops import _cuda
        self._cuda = _cuda
        self._saved = (_cuda.launch_target, _cuda.check)
        self.counts = {name: {} for name in KERNEL_OF_LAUNCH.values()}
        target, check = self._saved
        card = [None]

        def launch_target(dev):
            index, stream = target(dev)
            card[0] = index
            return index, stream

        def counted(lib, code, what):
            check(lib, code, what)
            per = self.counts[KERNEL_OF_LAUNCH[what]]
            per[card[0]] = per.get(card[0], 0) + 1

        _cuda.launch_target, _cuda.check = launch_target, counted
        return self

    def __exit__(self, *exc):
        self._cuda.launch_target, self._cuda.check = self._saved


def add_card_launches(total, counts) -> None:
    """Add ``counts`` ({kernel: {card: n}}, cards as ints or as the
    strings JSON makes of them) into ``total``."""
    for name, per in counts.items():
        into = total.setdefault(name, {})
        for card, n in per.items():
            into[int(card)] = into.get(int(card), 0) + n


class MeshCounts:
    """The mesh path's calls while open, with no synchronisation (the
    walls stay the run's): ``seeder`` and ``extender`` count the calls of
    the callables make_sharded_seeder and make_sharded_extender build;
    ``card_bytes`` adds up the bytes _seed_body copies between two cards:
    a data row's reads and lengths to each block shard on another card,
    and that shard's candidate tables (cnt and diag, int32 (B, 2, NB_l,
    K)) and block metadata back to the row's first card.  The package
    calls these through module attributes, which is what is replaced."""

    def __enter__(self):
        from aligngraph2_tpu_torch.parallel import sharded
        self._mod = sharded
        self.seeder = self.extender = self.card_bytes = 0
        self._saved = {n: getattr(sharded, n) for n in (
            "make_sharded_seeder", "make_sharded_extender", "_seed_body")}

        def counted(key):
            make = self._saved[f"make_sharded_{key}"]

            def build(*a, **kw):
                fn = make(*a, **kw)

                def call(*arrays):
                    setattr(self, key, getattr(self, key) + 1)
                    return fn(*arrays)
                return call
            return build

        body = self._saved["_seed_body"]

        def seed_body(q_fwd, q_rev, read_lens, index_row, **kw):
            reads = tensor_bytes(q_fwd, q_rev, read_lens)
            for bseq, bstart, sc, *_ in index_row:
                if sc.device != q_fwd.device:
                    tables = 2 * q_fwd.shape[0] * 2 * len(bseq) * kw["K"] * 4
                    self.card_bytes += (reads + tables
                                        + tensor_bytes(bseq, bstart))
            return body(q_fwd, q_rev, read_lens, index_row, **kw)

        sharded.make_sharded_seeder = counted("seeder")
        sharded.make_sharded_extender = counted("extender")
        sharded._seed_body = seed_body
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._mod, name, fn)


def sync_all() -> None:
    """Wait for every card."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def mesh_run(mesh, reads, ctgs):
    """Read -> contig for every read on ``mesh``, launch counts zeroed
    first, under CardLaunches, MeshCounts and RefCalls: (line of numbers,
    AlignmentSet, launches by kernel and card, static-band launches, plain
    calls on a card, the aligner)."""
    import torch
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    from aligngraph2_tpu_torch.config import AlignerConfig
    from aligngraph2_tpu_torch.ops import banded_static as bs

    n = len(reads)
    zero_launches()
    before = torch.cuda.current_device()
    with CardLaunches() as cl, MeshCounts() as mc, RefCalls() as rc:
        t0 = time.perf_counter()
        al = LongReadAligner(ctgs, AlignerConfig(), mesh=mesh)
        al._ensure_sharded_index()
        sync_all()
        index_s = time.perf_counter() - t0
        alns = al.align_reads(reads, ids=range(n))
        sync_all()
        wall = time.perf_counter() - t0
    line = {"mesh": mesh.shape,
            "devices": [str(d) for d in mesh.devices.flat], "reads": n,
            "wall_s": wall, "reads_per_s": n / wall, "index_s": index_s,
            "seeder_calls": mc.seeder, "extender_calls": mc.extender,
            "card_copy_bytes": mc.card_bytes, "alignments": len(alns),
            "aligned_reads": len({a.query_name for a in alns}),
            "current_card": [before, torch.cuda.current_device()]}
    static = bs.banded_dp_static.launches + bs.traceback_static.launches
    return line, alns, cl.counts, static, rc.cuda_calls, al


def mesh_grid(reads, ctgs, ref_text) -> dict:
    """Read -> contig for every read of the stage dataset on meshes that
    list the one card four times (MESH_GRID: 2x2 and 1x4): the block
    axis's split and concatenation and a per-shard index on a card.  Each
    .ref text must equal the mesh phase's 1x1 text on every read; each
    seeder and adaptive kernel must launch, and no static-band kernel or
    plain version may run on the card.  A line per mesh: wall, reads/s,
    seeder and extender calls, launches.  Returns each kernel's launches
    summed over the meshes."""
    import torch
    from aligngraph2_tpu_torch.parallel.mesh import make_mesh

    total = dict.fromkeys(all_launches(), 0)
    for block in MESH_GRID:
        mesh = make_mesh(devices=[torch.device("cuda", 0)] * 4,
                         block_parallel=block)
        line, alns, _, static, plain, _ = mesh_run(mesh, reads, ctgs)
        launches = all_launches()
        for k, v in launches.items():
            total[k] += v
        same = alns.to_ref_text() == ref_text
        emit({"phase": "mesh_grid", **line, "launches": launches,
              "plain_calls_on_card": plain, "ref_text_equal_1x1": same})
        if not same:
            raise SystemExit(f"mesh_grid {mesh.shape}: .ref text differs "
                             "from the 1x1 mesh's")
        need = ("banded_align", "traceback", "seed_block",
                "select_candidates")
        if static or plain or not all(launches[k] for k in need):
            raise SystemExit(f"mesh_grid {mesh.shape}: launches {launches}, "
                             f"{plain} plain calls on the card")
    return total


def cards_shapes(n: int) -> list:
    """The (data, block) meshes of real cards for --cards n: 2x1 and 1x2
    of cards 0 and 1; past two cards n x 1, (n/2) x 2 for an even n, and
    1 x n."""
    shapes = [(2, 1), (1, 2)]
    if n > 2:
        shapes += [(n, 1)] + ([(n // 2, 2)] if n % 2 == 0 else []) \
            + [(1, n)]
    return shapes


def off_card_calls(index, k, reads, ctgs, seed, last) -> dict:
    """seed_block and banded_align called directly on tensors on card
    ``last`` while card 0 is current, outside any device guard: the
    current card must be 0 after each, every output on ``last``, and
    equal to the same call's on card 0 (the first seed_gate shape; the
    adaptive gate's first shape)."""
    import numpy as np
    import torch
    from aligngraph2_tpu_torch.ops import banded_dp as bd
    from aligngraph2_tpu_torch.parallel import sharded

    dev = torch.device("cuda", last)
    _, arrays, kw = next(seed_gate_shapes(index, k, reads, ctgs, seed))
    B, NQ, W, x_drop = ADAPTIVE_GATE[0]
    lanes = tuple(torch.from_numpy(x).cuda() for x in adaptive_lanes(
        np.random.default_rng(seed + 2), B, NQ, W))
    calls = {
        "seed_block": (lambda a: sharded.seed_block(*a, **kw), arrays),
        "banded_align": (lambda a: tuple(bd.banded_align(
            *a, W=W, x_drop=x_drop)), lanes)}
    out = {}
    for name, (fn, args) in calls.items():
        want = fn(args)
        moved = tuple(x.to(dev) for x in args)
        torch.cuda.set_device(0)
        got = fn(moved)
        current = torch.cuda.current_device()
        on = sorted({str(g.device) for g in got})
        equal = all(torch.equal(w, g.to(w.device)) for w, g in zip(want, got))
        out[name] = {"card": last, "current_after": current,
                     "outputs_on": on, "equal_to_card_0": equal}
        if current != 0 or on != [str(dev)] or not equal:
            raise SystemExit(f"cards_mesh: {name} on card {last}: current "
                             f"card {current} after it, outputs on {on}, "
                             f"equal to card 0's {equal}")
    return out


def cards_mesh(args, n, reads, ctgs) -> dict:
    """Read -> contig for every read of the stage dataset on the 1x1 mesh
    of card 0 (after a warm-up run on the n x 1 mesh), then on each
    cards_shapes(n) mesh of real cards: every
    .ref text equal to card 0's; every card of a mesh launches the seed
    kernel and both adaptive kernels, the dedup kernel runs on each data
    row's first card (the row's gather) and on no other; the current
    card is the same before and after each run; and direct wrapper calls
    on the last card (:func:`off_card_calls`).  A line per mesh: wall,
    reads/s, seeder and extender calls, bytes copied between cards,
    launches by kernel and card.  Returns the launches by kernel and card
    over the meshes of real cards."""
    import torch
    from aligngraph2_tpu_torch.parallel.mesh import make_mesh

    # one run over every card first, so that no measured run pays a
    # card's first use (its context, the kernels' modules)
    every = make_mesh(devices=[torch.device("cuda", i) for i in range(n)],
                      block_parallel=1)
    emit({"phase": "cards_mesh", "warm_up": True,
          **mesh_run(every, reads, ctgs)[0]})
    line, alns, _, _, _, ref_al = mesh_run(
        make_mesh(devices=[torch.device("cuda", 0)]), reads, ctgs)
    ref_text = alns.to_ref_text()
    emit({"phase": "cards_mesh", **line, "reference": True})
    total = {}
    for data, block in cards_shapes(n):
        mesh = make_mesh(devices=[torch.device("cuda", i)
                                  for i in range(data * block)],
                         block_parallel=block)
        line, alns, counts, static, plain, _ = mesh_run(mesh, reads, ctgs)
        add_card_launches(total, counts)
        same = alns.to_ref_text() == ref_text
        cards = [d.index for d in mesh.devices.flat]
        homes = {d.index for d in mesh.devices[:, 0]}
        missing = [(name, c) for name in ("seed_block", "banded_align",
                                          "traceback")
                   for c in cards if not counts[name].get(c)]
        missing += [("select_candidates", c) for c in homes
                    if not counts["select_candidates"].get(c)]
        stray = sorted(set(counts["select_candidates"]) - homes) + sorted(
            c for per in counts.values() for c in per if c not in cards)
        emit({"phase": "cards_mesh", **line, "launches_by_card": counts,
              "plain_calls_on_card": plain, "static_launches": static,
              "ref_text_equal_card_0": same})
        if not same:
            raise SystemExit(f"cards_mesh {mesh.shape}: .ref text differs "
                             "from card 0's 1x1 mesh")
        if missing or stray or static or plain:
            raise SystemExit(f"cards_mesh {mesh.shape}: not launched "
                             f"{missing}, launched off their cards {stray}, "
                             f"{static} static launches, {plain} plain calls")
        if len(set(line["current_card"])) != 1:
            raise SystemExit(f"cards_mesh {mesh.shape}: the current card "
                             f"moved {line['current_card']}")
    calls = off_card_calls(ref_al._block_index, ref_al.cfg.seed_k, reads,
                           ctgs, args.seed, n - 1)
    emit({"phase": "cards_mesh", "off_card_calls": calls})
    return total


def cli_worker(report: str, sharded: str, argv: list) -> int:
    """One process of a --cards phase (``python3 chip_smoke.py --cli-worker
    REPORT 0|1 <CLI flags>``, in the environment its parent sets): the
    port's CLI on ``argv`` in this process, with ``sharded_align`` forced
    on when ``sharded`` is 1.  Writes to REPORT, as JSON: the rank and
    world size, the cards the process owns (local_cards) and its current
    card, the mesh run_pipeline built (shape and cards, or None), the
    all_reduce calls by the device of their tensor (the dense k-mer count
    sum is the one on a card: NCCL), each kernel's launches by card, and
    the cards on which torch allocated memory (peak bytes by card)."""
    import torch
    sys.path.insert(0, HERE)
    from aligngraph2_tpu_torch import cli
    from aligngraph2_tpu_torch.parallel import distributed
    from aligngraph2_tpu_torch.pipeline import driver

    seen = {"mesh": None, "all_reduce": {}}
    make = driver._make_mesh

    def traced_mesh(cfg):
        if sharded == "1":
            cfg.runtime.sharded_align = True
        mesh = make(cfg)
        if mesh is not None:
            seen["mesh"] = {"shape": mesh.shape,
                            "cards": [d.index for d in mesh.devices.flat]}
        return mesh

    all_reduce = torch.distributed.all_reduce

    def traced_all_reduce(t, *a, **kw):
        key = str(t.device)
        seen["all_reduce"][key] = seen["all_reduce"].get(key, 0) + 1
        return all_reduce(t, *a, **kw)

    driver._make_mesh = traced_mesh
    torch.distributed.all_reduce = traced_all_reduce
    t0 = time.perf_counter()
    with CardLaunches() as cl:
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    peak = {i: torch.cuda.max_memory_allocated(i)
            for i in range(torch.cuda.device_count())}
    with open(report, "w") as f:
        json.dump({"rank": distributed.process_index(),
                   "world": distributed.process_count(),
                   "local_cards": distributed.local_cards(),
                   "current_card": torch.cuda.current_device(),
                   "mesh": seen["mesh"], "all_reduce": seen["all_reduce"],
                   "launches_by_card": cl.counts,
                   "allocated_cards": [i for i, b in peak.items() if b],
                   "peak_bytes_by_card": peak, "rc": rc, "wall_s": wall},
                  f)
    return rc


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_cli(d, name, argv, nprocs, cards, sharded):
    """The CLI on ``argv`` in ``nprocs`` processes (:func:`cli_worker`),
    each seeing ``cards``, with the environment torchrun gives them
    (WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; none for one process), the backend switches at their
    default, writing to ``d``/``name``: (out dir, [(Popen, report path,
    log path)])."""
    out = os.path.join(d, name)
    env = {k: v for k, v in os.environ.items() if k not in SWITCHES}
    env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, cards))
    # the group's sockets on the loopback device: no host name lookup
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    port = str(free_port())
    procs = []
    for rank in range(nprocs):
        if nprocs > 1:
            env.update(WORLD_SIZE=str(nprocs), RANK=str(rank),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs),
                       MASTER_ADDR="localhost", MASTER_PORT=port)
        report = os.path.join(d, f"{name}.{rank}.json")
        log = os.path.join(d, f"{name}.{rank}.log")
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--cli-worker", report, "1" if sharded else "0", *argv,
                 "-o", out], cwd=HERE, env=dict(env), stdout=f,
                stderr=subprocess.STDOUT), report, log))
    return out, procs


def wait_cli(name, procs, timeout) -> list:
    """Wait for the processes of :func:`start_cli` (all of them killed
    once one fails or the time is up); their reports, in rank order."""
    deadline = time.monotonic() + timeout
    failed = None
    for p, _, log in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            failed = failed or f"timed out after {timeout} s"
        if p.returncode:
            failed = failed or f"exited {p.returncode}"
        if failed:
            for q, _, _ in procs:
                q.kill()
                q.wait()
            with open(log) as f:
                tail = f.read()[-4000:]
            raise SystemExit(f"{name}: a process {failed}:\n{tail}")
    reports = []
    for _, report, _ in procs:
        with open(report) as f:
            reports.append(json.load(f))
    return reports


def same_files(a, b, names) -> dict:
    """{name: whether file ``name`` is byte for byte the same in
    directories ``a`` and ``b``}."""
    out = {}
    for name in names:
        with open(os.path.join(a, name), "rb") as f1, \
                open(os.path.join(b, name), "rb") as f2:
            out[name] = f1.read() == f2.read()
    return out


def check_owned(name, reports) -> None:
    """Each process allocated memory only on the cards it owns."""
    for r in reports:
        if not set(r["allocated_cards"]) <= set(r["local_cards"]):
            raise SystemExit(f"{name}: rank {r['rank']} allocated on cards "
                             f"{r['allocated_cards']}, owns "
                             f"{r['local_cards']}")


def cards_pipeline(args, n) -> dict:
    """The 5 Mb PacBio pipeline (PIPELINE_DATA) through the CLI at its
    default flags and switches, in one process on cards 0 .. n-1, where
    the mesh is on by default (2x2 at four cards), and in one process on
    card 0 with sharded_align on (a 1x1 mesh): the five outputs must be
    equal.  Then the same in one process on card 0 at the defaults, the
    single-device path a one-card user runs (host seeding, the static
    band; its .ref files differ by design, so only its walls and
    identity are compared).  Stage walls of each, identity of the
    longest output to the truth.  Returns the launches by kernel and
    card of the runs."""
    import tempfile
    from aligngraph2_tpu_torch.io.fasta import read_seqs
    from tests.synth import make_dataset

    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cards_") as d:
        t0 = time.perf_counter()
        ds = make_dataset(seed=args.seed, **PIPELINE_DATA)
        paths = write_inputs(ds, d)
        setup_s = time.perf_counter() - t0
        argv = ["-r", paths[0], "-c", paths[1], "-g", paths[2]]
        runs = {}
        for name, cards, sharded in (("cards", range(n), False),
                                     ("card_0_mesh", [0], True),
                                     ("card_0", [0], False)):
            t0 = time.perf_counter()
            out, procs = start_cli(d, name, argv, 1, cards, sharded)
            (report,) = wait_cli(name, procs, CARDS_PIPELINE_TIMEOUT)
            wall = time.perf_counter() - t0
            with open(os.path.join(out, "metrics.json")) as f:
                metrics = json.load(f)
            recs = list(read_seqs(os.path.join(out, "final.fasta")))
            longest = max(recs, key=lambda r: len(r[1]), default=("", ""))
            ident, covered, _ = identity_to_truth(longest[1], ds["genome"])
            add_card_launches(total, report["launches_by_card"])
            runs[name] = out
            emit({"phase": "cards_pipeline", "run": name,
                  "cards": list(cards), "setup_s": setup_s,
                  "process_s": wall, "wall_s": metrics["wall_s"],
                  "reads_per_s": metrics["n_reads"] / metrics["wall_s"],
                  "stage_s": metrics["stage_s"],
                  "sharded_align": metrics["sharded_align"],
                  "mesh": metrics.get("mesh"), "mesh_cards":
                  (report["mesh"] or {}).get("cards"),
                  "n_chains": metrics["n_chains"],
                  "final_records": len(recs),
                  "identity_to_truth": ident, "covered_share": covered,
                  "launches_by_card": report["launches_by_card"],
                  "allocated_cards": report["allocated_cards"]})
            check_owned(f"cards_pipeline {name}", [report])
            # make_mesh's default block axis: 2 from four devices on
            block = 2 if len(cards) >= 4 else 1
            want = ({"data": len(cards) // block, "block": block}
                    if name != "card_0" else None)
            if metrics["sharded_align"] != (want is not None) or \
                    metrics.get("mesh") != want:
                raise SystemExit(f"cards_pipeline {name}: mesh "
                                 f"{metrics.get('mesh')}, {want} wanted")
            if ident <= 0.85:
                raise SystemExit(f"cards_pipeline {name}: identity {ident}")
        same = same_files(runs["cards"], runs["card_0_mesh"], OUTPUTS)
        emit({"phase": "cards_pipeline", "files_equal": same})
        if not all(same.values()):
            raise SystemExit(f"cards_pipeline: the {n}-card run's outputs "
                             f"differ from the 1x1 mesh's: {same}")
    return total


def cards_processes(args, n) -> dict:
    """The CLI on the cli phase's dataset (CLI_DATA, CLI_FLAGS: k = 12, so
    stage 1's dense count sum is an all_reduce on the cards, NCCL) in the
    torchrun environment: n processes of one card each (the mesh off)
    against one process on card 0; n/2 processes of two cards each (a 2x1
    mesh in each) against one process on card 0 with sharded_align on (a
    1x1 mesh).  The five outputs and the solid set must be equal; each
    process must allocate only on the cards it owns, and the sum must
    run on its card.  All four runs at once.  Returns the launches by
    kernel and card of the multi-process runs."""
    import tempfile
    from tests.synth import make_dataset

    names = (*OUTPUTS, "working_dir/solid_kmer_set.bin")
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_procs_") as d:
        ds = make_dataset(seed=args.seed, **CLI_DATA)
        paths = write_inputs(ds, d)
        argv = ["-r", paths[0], "-c", paths[1], "-g", paths[2], *CLI_FLAGS]
        runs = {"one_card": (1, [0], False),
                "one_card_mesh": (1, [0], True),
                "one_card_each": (n, range(n), False),
                "two_cards_each": (n // 2, range(n), False)}
        t0 = time.perf_counter()
        started = {name: start_cli(d, name, argv, nprocs, cards, sharded)
                   for name, (nprocs, cards, sharded) in runs.items()}
        reports = {name: wait_cli(name, procs, CARDS_CLI_TIMEOUT)
                   for name, (_, procs) in started.items()}
        wall = time.perf_counter() - t0
        out = {name: o for name, (o, _) in started.items()}
        for name, reps in reports.items():
            nprocs, cards, _ = runs[name]
            emit({"phase": "cards_processes", "run": name,
                  "processes": nprocs,
                  "per_process": [{k: r[k] for k in (
                      "rank", "world", "local_cards", "current_card", "mesh",
                      "all_reduce", "allocated_cards", "wall_s")}
                      for r in reps],
                  "launches_by_card": [r["launches_by_card"] for r in reps]})
            check_owned(f"cards_processes {name}", reps)
            for r in reps:
                own = r["local_cards"]
                mesh = {"one_card": None,
                        "one_card_mesh": {"shape": {"data": 1, "block": 1},
                                          "cards": [0]},
                        "one_card_each": None,
                        "two_cards_each": {"shape": {"data": 2, "block": 1},
                                           "cards": own}}[name]
                if len(own) != len(cards) // nprocs or \
                        r["current_card"] != own[0] or r["mesh"] != mesh:
                    raise SystemExit(f"cards_processes {name}: rank "
                                     f"{r['rank']} owns {own}, current "
                                     f"{r['current_card']}, mesh "
                                     f"{r['mesh']} ({mesh} wanted)")
                if nprocs > 1 and not r["all_reduce"].get(f"cuda:{own[0]}"):
                    raise SystemExit(f"cards_processes {name}: rank "
                                     f"{r['rank']} summed no counts on its "
                                     f"card: {r['all_reduce']}")
                if name in ("one_card_each", "two_cards_each"):
                    add_card_launches(total, r["launches_by_card"])
        same = {"one_card_each": same_files(out["one_card_each"],
                                            out["one_card"], names),
                "two_cards_each": same_files(out["two_cards_each"],
                                             out["one_card_mesh"], names)}
        emit({"phase": "cards_processes", "wall_s": wall,
              "files_equal": same})
        if not all(all(v.values()) for v in same.values()):
            raise SystemExit(f"cards_processes: files differ {same}")
    return total


def cards_main(args, t_script) -> int:
    """``--cards N``: the multi-card phases on cards 0 .. N-1 (cards_mesh,
    cards_pipeline, cards_processes, cards_launches), after the build and
    the probe; raises when fewer than N cards are present.  Ends with
    every card's nvidia-smi line and the contract line."""
    import torch
    n = args.cards
    present = torch.cuda.device_count()
    if n < 2 or present < n:
        raise SystemExit(f"--cards {n}: needs at least 2 and at most the "
                         f"{present} cards present")
    cards = nvidia_smi()
    built = build_all()
    emit({"phase": "card", "nvidia_smi": cards, "cards": present,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nccl": ".".join(map(str, torch.cuda.nccl.version())), **built})
    probe()
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    ds = stage_dataset(args.seed, args.genome_mb)
    by_phase = {"cards_mesh": cards_mesh(args, n, SeqDatabase(ds["reads"]),
                                         SeqDatabase(ds["contigs"]))}
    del ds
    by_phase["cards_pipeline"] = cards_pipeline(args, n)
    by_phase["cards_processes"] = cards_processes(args, n)
    total = {}
    for counts in by_phase.values():
        add_card_launches(total, counts)
    emit({"phase": "cards_launches", "by_phase": by_phase, "total": total})
    emit({"phase": "total", "script_s": time.perf_counter() - t_script})
    print("\n".join(cards), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": present}})
    return 0


def probe() -> dict:
    """The link probe and what ``auto`` resolves to on this card."""
    from aligngraph2_tpu_torch.utils import devprobe
    rates = devprobe.measure_link("cuda")
    with switches("auto"):
        auto = {var: devprobe.resolve_backend(var, "cuda")
                for var in SWITCHES}
    emit({"phase": "probe", "up_mbps": rates["up"],
          "down_mbps": rates["down"],
          "link_mbps": devprobe.link_bandwidth_mbps("cuda"),
          "device_min_mbps": devprobe.DEVICE_MIN_MBPS, "auto": auto})
    return auto


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


@contextlib.contextmanager
def switches(value):
    """Both backend switches set to ``value`` in this process, and put
    back after."""
    old = {var: os.environ.get(var) for var in SWITCHES}
    os.environ.update({var: value for var in SWITCHES})
    try:
        yield
    finally:
        for var, val in old.items():
            if val is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = val


def tensor_bytes(*objs) -> int:
    """Bytes of the tensors in ``objs`` (nested in tuples, lists and
    dicts)."""
    import torch
    n = 0
    for obj in objs:
        if isinstance(obj, torch.Tensor):
            n += obj.numel() * obj.element_size()
        elif isinstance(obj, dict):
            n += tensor_bytes(*obj.values())
        elif isinstance(obj, (tuple, list)):
            n += tensor_bytes(*obj)
    return n


def synced_ms(fn, *args, **kw):
    """(milliseconds, result) of one call, the card synchronised before
    and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


class DeviceCalls:
    """The port's device merge and consensus, wrapped in this process.

    While open, every call of ``merge_positions_device``,
    ``merge_edges_device`` and ``consensus_backbone_device`` is kept in
    ``calls``: its arguments, result and card ms (synchronised before and
    after); the host<->device copies it makes (utils/transfer.py) are
    timed apart, with their bytes; inside the consensus, ``_agg_columns``
    and ``_chain_sort`` are timed on their own, with the rows they take
    (columns, chain records) and the bytes of their tensors.  The package
    dispatches through module attributes, which is what is replaced here;
    no package file changes."""

    ENTRIES = ("merge_positions_device", "merge_edges_device",
               "consensus_backbone_device")
    INNER = {"_agg_columns": lambda a: int(a[0].numel()),
             "_chain_sort": lambda a: int(a[0]["win"].numel())}

    def __init__(self):
        self.calls = []
        self._open = None

    def __enter__(self):
        from aligngraph2_tpu_torch.consensus import device as cd
        from aligngraph2_tpu_torch.graph import merge_device as md
        from aligngraph2_tpu_torch.utils import transfer
        where = {"to_device": transfer, "to_host": transfer,
                 "merge_positions_device": md, "merge_edges_device": md,
                 "consensus_backbone_device": cd, "_agg_columns": cd,
                 "_chain_sort": cd}
        self._saved = [(mod, name, getattr(mod, name))
                       for name, mod in where.items()]
        for mod, name, fn in self._saved:
            wrap = (self._copy if name.startswith("to_") else
                    self._entry if name in self.ENTRIES else self._inner)
            setattr(mod, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def _copy(self, name, fn):
        def copy(x, *args):
            ms, out = synced_ms(fn, x, *args)
            if self._open is not None:
                self._open["copy_ms"] += ms
                self._open["copy_bytes"] += (x if name == "to_device"
                                             else out).nbytes
            return out
        return copy

    def _entry(self, name, fn):
        def entry(*args, **kw):
            rec = {"fn": name, "args": args, "copy_ms": 0.0,
                   "copy_bytes": 0, "inner": {}}
            self._open = rec
            try:
                rec["ms"], rec["out"] = synced_ms(fn, *args, **kw)
            finally:
                self._open = None
            self.calls.append(rec)
            return rec["out"]
        return entry

    def _inner(self, name, fn):
        def inner(*args, **kw):
            ms, out = synced_ms(fn, *args, **kw)
            if self._open is not None:
                d = self._open["inner"].setdefault(
                    name, {"calls": 0, "ms": 0.0, "rows": 0, "bytes": 0})
                d["calls"] += 1
                d["ms"] += ms
                d["rows"] += self.INNER[name](args)
                d["bytes"] += tensor_bytes(args, kw, out)
            return out
        return inner


def bytes_bound_ms(nbytes: int) -> float:
    """Least time to read or write ``nbytes`` once at the HBM rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def device_paths(calls) -> dict:
    """The native core on each input the pipeline's device paths took:
    every output must be equal.  Prints one line per call and per device
    function; returns the per-function summary."""
    import numpy as np
    from aligngraph2_tpu_torch.consensus.native import (
        consensus_backbone_native)
    from aligngraph2_tpu_torch.graph.ingest_native import (
        merge_edges_native, merge_positions_native)

    t_phase = time.perf_counter()
    rows, bad = [], []
    for i, c in enumerate(calls):
        a, out = c["args"], c["out"]
        t0 = time.perf_counter()
        if c["fn"] == "merge_positions_device":
            node, ctg, ref, cnt, eps = a[:5]
            want = merge_positions_native(node, ctg, ref, cnt,
                                          int(node.max()) + 1, eps)
            size = {"positions": len(node), "clusters": len(out[0])}
        elif c["fn"] == "merge_edges_device":
            want = merge_edges_native(*a[:3])
            size = {"edges": len(a[0]), "distinct": len(out[0])}
        else:
            want = consensus_backbone_native(*a[:7])
            size = {"backbone_bp": len(a[0]), "alignments": len(a[1]),
                    "columns": c["inner"].get("_agg_columns",
                                              {}).get("rows", 0),
                    "chain_records": c["inner"].get("_chain_sort",
                                                    {}).get("rows", 0)}
        native_ms = (time.perf_counter() - t0) * 1e3
        if isinstance(out, str):
            same = want == out
        else:
            same = want is not None and all(
                np.array_equal(x, y) for x, y in zip(out, want))
        if not same:
            bad.append(i)
        nbytes = c["copy_bytes"]
        rows.append({"fn": c["fn"], **size, "equal": same, "ms": c["ms"],
                     "copy_ms": c["copy_ms"], "native_ms": native_ms,
                     "bytes": nbytes, "bound_ms": bytes_bound_ms(nbytes),
                     "inner": c["inner"]})
    by_fn = {}
    for name, replaces in DEVICE_FUNCTIONS.items():
        if name in DeviceCalls.ENTRIES:
            mine = [r for r in rows if r["fn"] == name]
            n = len(mine)
            ms = sum(r["ms"] for r in mine)
            nbytes = sum(r["bytes"] for r in mine)
            extra = {"copy_ms_per_call": sum(r["copy_ms"] for r in mine)
                     / max(n, 1),
                     "native_ms_per_call": sum(r["native_ms"] for r in mine)
                     / max(n, 1)}
        else:
            # one call per column batch of a consensus call; the copies
            # and the native core belong to the whole consensus call
            mine = [r for r in rows if name in r["inner"]]
            n = sum(r["inner"][name]["calls"] for r in mine)
            ms = sum(r["inner"][name]["ms"] for r in mine)
            nbytes = sum(r["inner"][name]["bytes"] for r in mine)
            extra = {"consensus_calls": len(mine),
                     "copy_ms_of_consensus_calls": sum(r["copy_ms"]
                                                       for r in mine),
                     "native_ms_of_consensus_calls": sum(r["native_ms"]
                                                         for r in mine)}
        per = nbytes / max(n, 1)
        by_fn[name] = {"replaces": replaces, "calls": n,
                       "ms_per_call": ms / max(n, 1), **extra,
                       "bytes_per_call": per,
                       "bound_ms_per_call": bytes_bound_ms(per)}
    emit({"phase": "device_paths", "calls": rows, "by_function": by_fn,
          "all_equal": not bad, "phase_s": time.perf_counter() - t_phase})
    missing = [fn for fn in DeviceCalls.ENTRIES
               if not any(r["fn"] == fn for r in rows)]
    if missing:
        raise SystemExit(f"device_paths: never called in the pipeline: "
                         f"{missing}")
    if bad:
        raise SystemExit(f"device_paths: calls {bad} differ from the "
                         "native core")
    return by_fn


def merge_sweep(calls) -> list:
    """The positions merge on the card against the native core on
    prefixes of the largest positions input the pipeline kept, each timed
    on its second call; outputs must be equal."""
    import numpy as np
    from aligngraph2_tpu_torch.graph.ingest_native import (
        merge_positions_native)
    from aligngraph2_tpu_torch.graph.merge_device import (
        merge_positions_device)

    big = max((c for c in calls if c["fn"] == "merge_positions_device"),
              key=lambda c: len(c["args"][0]))
    node, ctg, ref, cnt, eps = big["args"][:5]
    rows = []
    for n in MERGE_SWEEP_ROWS:
        if n > len(node):
            continue
        a = [x[:n] for x in (node, ctg, ref, cnt)]
        nodes = int(a[0].max()) + 1
        for _ in range(2):
            t0 = time.perf_counter()
            want = merge_positions_native(*a, nodes, eps)
            native_ms = (time.perf_counter() - t0) * 1e3
            device_ms, got = synced_ms(merge_positions_device, *a, eps,
                                       "cuda")
        rows.append({"rows": n, "device_ms": device_ms,
                     "native_ms": native_ms,
                     "native_over_device": native_ms / device_ms,
                     "equal": all(np.array_equal(x, y)
                                  for x, y in zip(got, want))})
    emit({"phase": "merge_sweep", "input_rows": len(node), "sweep": rows})
    if not all(r["equal"] for r in rows):
        raise SystemExit("merge_sweep: device and native merges differ")
    return rows


def pipeline(args):
    """The whole pipeline on CUDA at 5 Mb, through run_pipeline with the
    CLI's default config and both switches at ``device``; returns each
    kernel's launches in the run and the device paths' calls
    (DeviceCalls.calls)."""
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
        with switches("device"), DeviceCalls() as dc:
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
              "switches": {var: "device" for var in SWITCHES},
              "device_calls": len(dc.calls),
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
    return launches, dc.calls


def cli_run(args, auto) -> None:
    """The CLI as a subprocess on the card with both switches at their
    default ``auto`` (``auto`` as the probe resolved it in this process),
    and the same inputs in-process through the plain versions and the
    native cores: the five outputs must be equal."""
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
            timeout=600, env={k: v for k, v in os.environ.items()
                              if k not in SWITCHES})
        cli_s = time.perf_counter() - t0
        if res.returncode != 0:
            raise SystemExit(f"cli exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
        cfg = cli_config([*argv, "-o", out_plain])
        cfg.runtime.plain = True
        cfg.runtime.progress = False
        t0 = time.perf_counter()
        with switches("native"):
            plain = run_pipeline(*paths[:3], out_plain, cfg,
                                 log=lambda *a: None)
        plain_s = time.perf_counter() - t0
        with open(os.path.join(out_cli, "metrics.json")) as f:
            metrics = json.load(f)
        same = same_files(out_cli, out_plain, OUTPUTS)
        emit({"phase": "cli", "genome_bp": len(ds["genome"]),
              "reads": len(ds["reads"]), "flags": CLI_FLAGS,
              "cli_switches": {var: f"auto ({val} here)"
                               for var, val in auto.items()},
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
    if sys.argv[1:2] == ["--cli-worker"]:
        return cli_worker(sys.argv[2], sys.argv[3], sys.argv[4:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--genome-mb", type=float, default=1.0)
    ap.add_argument("--cards", type=int, default=0,
                    help="run only the multi-card phases, on cards 0 .. "
                         "N-1 (at least 2)")
    args = ap.parse_args()
    t_script = time.perf_counter()

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
    if args.cards:
        return cards_main(args, t_script)
    card = nvidia_smi()[0]
    built = build_all()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda, **built})
    auto = probe()
    timing = gate(args, built["regs"])
    a_timing = adaptive_gate(args, built["regs"])
    # the CPU halves of long_read, mesh and widths run side by side
    with concurrent.futures.ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn")) as pool:
        on_cpu, mesh_cpu, widths_cpu, reads, ctgs = slice_run(args, pool)
        a_launches = {"long_read": long_read(args, on_cpu)}
        a_launches["mesh"], s_launches, seed_t, select_t, mesh_text = mesh(
            args, built["regs"], reads, ctgs, mesh_cpu)
        g_launches = mesh_grid(reads, ctgs, mesh_text)
        del reads, ctgs, mesh_text
        w_launches = widths(args, widths_cpu)
    launches, calls = pipeline(args)
    device_paths(calls)
    merge_sweep(calls)
    del calls
    cli_run(args, auto)
    emit({"phase": "total", "script_s": time.perf_counter() - t_script})
    kernels = []
    # launches on each path that runs the kernel: the pipeline's aligner
    # stages and the widths phase (the static band); the long read, the
    # mesh, mesh_grid and widths phases (the adaptive band); the mesh,
    # mesh_grid and widths phases (the seeder)
    for name, key, replaces in (
            ("banded_dp_static", "dp",
             "aligngraph2_tpu/ops/banded_pallas.py:54"),
            ("traceback_static", "tb",
             "aligngraph2_tpu/ops/banded_pallas.py:375")):
        ms, plain_ms, bound, by = timing[key]
        by_phase = {"pipeline": launches[name], "widths": w_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "aligngraph2_tpu_torch/csrc/banded_static.cu",
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": float(timing["err"][key]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    # the adaptive band's: launches on the paths that run it, the mesh
    # extender (mesh, mesh_grid, widths) and the long read; times at the
    # gate's mesh shape
    for name, key, replaces in (
            ("banded_align", "dp", "aligngraph2_tpu/ops/banded_dp.py:106"),
            ("traceback", "tb", "aligngraph2_tpu/ops/banded_dp.py:244")):
        ms, plain_ms, bound, by = a_timing[key]
        by_phase = {ph: n[name] for ph, n in a_launches.items()}
        by_phase["mesh_grid"] = g_launches[name]
        by_phase["widths"] = w_launches[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "aligngraph2_tpu_torch/csrc/banded_adaptive.cu",
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": float(a_timing["err"][key]), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    # the mesh seeder's: launches in the mesh, mesh_grid and widths
    # phases; times at the seed gate's S=32 x 8192 and the select gate's
    # B=32, N=96
    for name, t, replaces in (
            ("seed_block", seed_t,
             "aligngraph2_tpu/parallel/sharded.py:126"),
            ("select_candidates", select_t,
             "aligngraph2_tpu/parallel/sharded.py:171")):
        by_phase = {"mesh": s_launches[name],
                    "mesh_grid": g_launches[name], "widths": w_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "aligngraph2_tpu_torch/csrc/seed_mesh.cu",
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": float(t["err"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
