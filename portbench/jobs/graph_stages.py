"""The job of the pipeline's graph stages: stages 6-8 of the CLI's
``pipeline/driver.py::run_pipeline`` (the graph build and traversal, the
alignment of the reads to the new backbones, the windowed consensus)
rerun from the stage cache over the whole deployment, as a user reruns
them with stages 1-5 cached.

Set-up writes the deployment's reads, draft contigs and similar genome to
FASTA files in a work dir under the run's temporary dir.  The first job
(the harness's warm-up) runs ``run_pipeline`` from an empty cache, all
eight stages; it keeps every call of the device merges
(``graph/merge_device.py``) with its inputs and outputs on the host.
Every later job removes the markers that make the driver redo stages 6,
7 and 8 and calls ``run_pipeline`` again: it raises unless stages 1-5
came from the cache and stages 6-8 ran in full.

The program runs ``PipelineConfig()`` at the CLI's defaults on one card,
its merge and consensus switches at ``auto``, with the traffic file's
``aligner`` (every field stated) and any ``graph``, ``preprocess``,
``consensus`` or ``runtime`` fields it lists.  On the CPU the aligner
takes the static band's plain versions, the band a card runs.

The check: stage 7's records (``merge.ref``) read by read against the
plain reference on the single path, whose target is the backbones the
warm-up wrote (``all.fasta``); each kept merge call against the frozen
numpy merge (``reference/merge.py``); every later job's outputs against
the warm-up's; at least one chain a job.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..deployment import seqs
from ..harness import log
from ..reference import merge as ref_merge
from ..reference.align import Reference

# under the working dir: what makes the driver redo stages 6, 7 and 8
RERUN_MARKERS = ("pagraph/CHECK", "pagraph/*/DONE", "cns/wrk/CHECK",
                 "cns/wrk/merge.ref", "cns/output/CHECK")
# the driver's log line that opens each stage; the next line says "Reuse"
# when the stage came from the cache
CACHED = ("K-Mer counting...", "Read to Contig...", "Read to Ref...",
          "Contig to Ref...", "Pre process...")
RERUN = ("Align and split...", "Correct...")
# text outputs a rerun must write again alike (out dir relative)
OUTPUTS = ("final.fasta", "add.fasta", "connect_info.txt",
           "working_dir/cns/output/cor.fasta",
           "working_dir/cns/input/all.fasta")
STAGES = ("pagraph", "extract", "align_split", "correct")
BACKENDS = {"merge": ("native", "device", "numpy"),
            "consensus": ("native", "device", "spec")}
MERGES = ("merge_positions_device", "merge_edges_device")
BASES = np.frombuffer(b"ACGT", np.uint8)


def _write_fasta(path: str, s) -> None:
    with open(path, "wb") as f:
        for i, name in enumerate(s.names):
            f.write(b">%s\n%s\n" % (name.encode(), BASES[s.get(i)].tobytes()))


def _read_fasta(path: str):
    """A FASTA file as Seqs, by the pipeline's rule for a target's bases:
    A, C, G, T in either case are 0-3, any other letter counts as A."""
    codes = np.zeros(256, np.uint8)
    for i, b in enumerate(b"ACGT"):
        codes[b] = codes[b + 32] = i
    names, arrays = [], []
    with open(path, "rb") as f:
        for rec in f.read().split(b">")[1:]:
            head, _, body = rec.partition(b"\n")
            names.append(head.split()[0].decode())
            arrays.append(codes[np.frombuffer(body.replace(b"\n", b""),
                                              np.uint8)])
    return seqs(arrays, names)


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _keeping(fn, kept: list):
    """``fn`` that appends (name, inputs, outputs) of each call to
    ``kept``, every array copied to the host."""
    def call(*args):
        out = fn(*args)
        kept.append((fn.__name__,
                     tuple(np.array(a) if isinstance(a, np.ndarray) else a
                           for a in args),
                     tuple(np.array(o) for o in out)))
        return out
    return call


def frozen_merge(name: str, inputs: tuple) -> tuple:
    """The frozen numpy merge of a kept call's arguments: (node, ctg, ref,
    count, epsilon, device) or (from, to, step, n_nodes, device)."""
    if name == "merge_positions_device":
        return ref_merge.merge_positions(*inputs[:4], epsilon=inputs[4])
    return ref_merge.merge_edges(*inputs[:3])


def same_arrays(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(a, b))


class Job:
    def __init__(self, dep: dict, traffic: dict, devices: list):
        from aligngraph2_tpu_torch.config import AlignerConfig, PipelineConfig
        if len(devices) != 1:
            raise ValueError("the graph stages run on one device")
        self.traffic = traffic
        self.reads = dep["reads"]
        cfg = PipelineConfig()
        cfg.aligner = AlignerConfig(**traffic["aligner"])
        for part in ("graph", "preprocess", "consensus", "runtime"):
            for k, v in traffic.get(part, {}).items():
                setattr(getattr(cfg, part), k, v)
        cfg.runtime.device = devices[0].type
        cfg.runtime.plain = devices[0].type == "cpu"
        cfg.runtime.sharded_align = False
        cfg.runtime.progress = False
        self.cfg = cfg
        self.work = tempfile.mkdtemp(prefix="portbench_graph_")
        self.out = os.path.join(self.work, "out")
        self.inputs = tuple(os.path.join(self.work, n) for n in
                            ("reads.fa", "ctg.fa", "genome.fa"))
        for path, part in zip(self.inputs, ("reads", "contigs", "similar")):
            _write_fasta(path, dep[part])
        self.kept = []          # the warm-up's merge calls
        self.first = None       # the warm-up's output digests
        self.backbones = None   # the warm-up's all.fasta
        self.jobs = 0
        self.outputs_differing = 0
        self.n_chains = []      # each later job's
        self.totals = {f"stage_s.{s}": 0.0 for s in STAGES}
        self.totals["n_chains"] = 0
        for sw, names in BACKENDS.items():
            self.totals.update({f"{sw}.{b}": 0 for b in names})

    def warmup_ids(self, job_reads: int) -> list:
        return list(range(len(self.reads)))

    def _pipeline(self):
        from aligngraph2_tpu_torch.pipeline.driver import run_pipeline
        msgs = []
        res = run_pipeline(*self.inputs, self.out, self.cfg,
                           log=lambda *a: msgs.append(" ".join(map(str, a))))
        return res.stats, msgs

    def run(self, ids):
        """One job over the whole pool; returns the path of stage 7's
        records."""
        if sorted(ids) != list(range(len(self.reads))):
            raise ValueError("a job of the graph stages takes the whole pool")
        if self.first is None:
            stats, msgs = self._warmup()
        else:
            wrk = os.path.join(self.out, "working_dir")
            for pat in RERUN_MARKERS:
                for p in glob.glob(os.path.join(wrk, *pat.split("/"))):
                    os.remove(p)
            stats, msgs = self._pipeline()
            after = {m: msgs[msgs.index(m) + 1] if m in msgs else None
                     for m in CACHED + RERUN}
            redone = [m for m in CACHED if after[m] != "Reuse"]
            reused = [m for m in RERUN if after[m] == "Reuse"]
            if redone or reused or stats["reused_groups"]:
                raise RuntimeError(
                    f"not a rerun of stages 6-8: stages redone {redone}, "
                    f"reused {reused}, {stats['reused_groups']} groups "
                    f"reused")
            self.n_chains.append(stats["n_chains"])
        self.jobs += 1
        for s in STAGES:
            self.totals[f"stage_s.{s}"] += stats["stage_s"][s]
        self.totals["n_chains"] += stats["n_chains"]
        from aligngraph2_tpu_torch.utils.backend import resolve_backend
        b_merge, b_cns = (
            resolve_backend(f"ALIGNGRAPH2_TPU_TORCH_{sw.upper()}", names,
                            self.cfg.runtime.device)
            for sw, names in BACKENDS.items())
        self.totals[f"merge.{b_merge}"] += 1
        self.totals[f"consensus.{b_cns}"] += 1
        log(f"graph job {self.jobs}: stage s "
            f"{ {s: stats['stage_s'][s] for s in STAGES} }, "
            f"{stats['n_chains']} chains, merge {b_merge}, consensus {b_cns}")
        digests = {n: _digest(os.path.join(self.out, n)) for n in OUTPUTS}
        if self.first is None:
            self.first = digests
            self.backbones = _read_fasta(os.path.join(self.out, OUTPUTS[-1]))
        else:
            self.outputs_differing += sum(digests[n] != self.first[n]
                                          for n in OUTPUTS)
        return {"merge_ref": os.path.join(self.out, "working_dir", "cns",
                                          "wrk", "merge.ref")}

    def _warmup(self):
        """The first run, all eight stages from an empty cache, with every
        device merge call kept."""
        from aligngraph2_tpu_torch.graph import merge_device
        real = {n: getattr(merge_device, n) for n in MERGES}
        try:
            for n in MERGES:
                setattr(merge_device, n, _keeping(real[n], self.kept))
            return self._pipeline()
        finally:
            for n in MERGES:
                setattr(merge_device, n, real[n])

    @staticmethod
    def texts(output, names) -> dict:
        """{read name: [record text, ...]} of stage 7's records in the
        file's order, for the reads named in ``names``."""
        out = {}
        if not os.path.exists(output["merge_ref"]):   # no chain, no stage 7
            return out
        with open(output["merge_ref"]) as f:
            while True:
                head = f.readline()
                if not head:
                    break
                rec = head + f.readline() + f.readline()
                name = head.split("\t", 1)[0]
                if name in names:
                    out.setdefault(name, []).append(rec)
        return out

    def counters(self) -> dict:
        return dict(self.totals)

    def close(self) -> None:
        """Remove the work dir (the program's files and stage cache)."""
        shutil.rmtree(self.work, ignore_errors=True)

    # ---- the check ----

    def reference(self, device) -> Reference:
        """Stage 7's plain reference: the single path over the backbones
        the warm-up wrote, with the traffic file's aligner settings."""
        return Reference(self.backbones, self.traffic["aligner"], "single",
                         device=device)

    def ref_device(self, devices):
        return devices[0] if devices[0].type == "cuda" else \
            torch.device("cpu")

    def check(self) -> dict:
        """Each kept merge call against the frozen merge, the later jobs'
        outputs against the warm-up's, and their chains."""
        t0 = time.perf_counter()
        # numpy's sorts release the interpreter lock: one thread a call
        with ThreadPoolExecutor(max_workers=max(1, len(self.kept))) as pool:
            differing = sum(pool.map(
                lambda c: not same_arrays(frozen_merge(c[0], c[1]), c[2]),
                self.kept))
        log(f"frozen merge: {len(self.kept)} calls "
            f"({sum(len(i[0]) for _, i, _ in self.kept)} rows) in "
            f"{time.perf_counter() - t0:.1f} s, {differing} differing")
        return {
            "merge_calls_checked": {"value": len(self.kept), "limit": 1,
                                    "rule": ">="},
            "merge_calls_differing": {"value": differing, "limit": 0,
                                      "rule": "<="},
            "outputs_differing": {"value": self.outputs_differing,
                                  "limit": 0, "rule": "<="},
            "n_chains": {"value": min(self.n_chains, default=0), "limit": 1,
                         "rule": ">="}}
