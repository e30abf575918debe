"""The job of an aligner stage: one ``LongReadAligner.align_reads(reads,
ids=...)`` call on the aligner the set-up built, over the next
``job_reads`` reads of the pool.

The traffic file names the target ("contigs" or "similar"), the path
("single": host seeding and the static band on one card; "mesh": the
mesh path over the cell's cards in the (data, block) shape it gives), and
every setting of the aligner: the program gets them as its
``AlignerConfig``, the reference reads them from the file.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.align import Reference, bucket

# the program's launch counters read around the window: {name: (module of
# the port, function whose ``.launches`` counts)}
COUNTERS = {
    "banded_dp_static.launches": ("ops.banded_static", "banded_dp_static"),
    "traceback_static.launches": ("ops.banded_static", "traceback_static"),
    "banded_align.launches": ("ops.banded_dp", "banded_align"),
    "traceback.launches": ("ops.banded_dp", "traceback"),
    "seed_block.launches": ("parallel.sharded", "seed_block"),
    "select_candidates.launches": ("parallel.sharded", "select_candidates"),
}


def _db(seqs):
    from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
    return SeqDatabase.from_arrays(seqs.codes, seqs.offsets, seqs.names)


class Job:
    def __init__(self, dep: dict, traffic: dict, devices: list):
        from aligngraph2_tpu_torch.align.aligner import LongReadAligner
        from aligngraph2_tpu_torch.config import AlignerConfig
        from aligngraph2_tpu_torch.parallel.mesh import make_mesh
        self.traffic = traffic
        self.reads = dep["reads"]
        self.target = dep[traffic["target"]]
        self.cfg = AlignerConfig(**traffic["aligner"])
        self.path = traffic["path"]["kind"]
        self.read_db = _db(self.reads)
        target_db = _db(self.target)
        if self.path == "mesh":
            data, block = traffic["path"]["mesh"]
            if data * block != len(devices):
                raise ValueError(f"a {data}x{block} mesh on "
                                 f"{len(devices)} devices")
            mesh = make_mesh(devices=devices, block_parallel=block)
            self.aligner = LongReadAligner(target_db, self.cfg, mesh=mesh)
        elif self.path == "single":
            self.aligner = LongReadAligner(target_db, self.cfg,
                                           device=devices[0], band="static")
        else:
            raise ValueError(f"path {self.path!r}: 'single' or 'mesh'")

    def warmup_ids(self, job_reads: int) -> list:
        """One job's worth of reads from the end of the pool, and the
        longest read of every length bucket of the pool that they miss, so
        every bucket and batch shape the window meets has run once."""
        n = len(self.reads)
        ids = list(range(max(0, n - job_reads), n))
        lens = self.reads.lengths
        seen = {bucket(int(lens[i])) for i in ids}
        longest = {}
        for i in np.argsort(lens, kind="stable"):
            if lens[i] <= self.cfg.max_read_len:
                longest[bucket(int(lens[i]))] = int(i)
        return ids + [i for b, i in sorted(longest.items()) if b not in seen]

    def run(self, ids):
        return self.aligner.align_reads(self.read_db, ids=ids)

    def counters(self) -> dict:
        import importlib
        out = {}
        for name, (mod, obj) in COUNTERS.items():
            m = importlib.import_module("aligngraph2_tpu_torch." + mod)
            out[name] = getattr(m, obj).launches
        out["dp_cells"] = self.aligner.dp_cells
        return out

    def close(self) -> None:
        """Free the program's state (the aligner, its index and buffers)."""
        self.aligner = None

    # ---- the check ----

    @staticmethod
    def texts(output, names) -> dict:
        """{read name: [record text, ...]} in the output's order, for the
        reads named in ``names``."""
        out = {}
        for a in output:
            if a.query_name not in names:
                continue
            out.setdefault(a.query_name, []).append(
                f"{a.query_name}\t{a.ref_name}\t{'F' if a.forward else 'R'}"
                f"\t{a.score}\t{a.qb}\t{a.qe}\t{a.qsize}\t{a.rb}\t{a.re}\t"
                f"{a.rsize}\n{a.qstr}\n{a.tstr}\n")
        return out

    def reference(self, device) -> Reference:
        """The plain reference of this job, from the traffic file's
        settings (every field the reference reads is stated there)."""
        return Reference(self.target, self.traffic["aligner"], self.path,
                         device=device)

    def ref_device(self, devices):
        return devices[0] if devices[0].type == "cuda" else \
            torch.device("cpu")
