"""The job of ``align_reads.py``, with its check's per-read seeding spread
over forked processes.

The job, its settings and its records are ``align_reads.Job``'s.  Only the
check's reference differs in how it runs: the same plain reference
(``reference/align.py``, ``reference/seed.py``), whose seeding of each
checked read (``_lanes_mesh`` / ``_lanes_single``) runs in a pool of
processes forked after its index is built, so they share the index; the
band and the records then run as the reference runs them.  The records it
compares are the same, read for read.

Why: the reference seeds a read over the whole target in numpy, and a read
in a repeat family meets every copy of it.  On a 119 Mb genome with the
deployments' repeat model (about 1,300 copies of each family) that is
about 4.6 s a read, 52 reads 236-246 s in one process, which took a run
past 360 s.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

from ..reference.align import Reference
from . import align_reads

# the reference and the reads the forked workers read (set before the fork)
_SHARED = {}


def _seed_one(rid):
    ref, reads = _SHARED["ref"], _SHARED["reads"]
    return ref.seed_one(rid, reads.get(rid))


class PooledReference(Reference):
    """:class:`Reference` whose per-read seeding runs in ``workers``
    forked processes."""

    workers = min(8, os.cpu_count() or 1)
    _seeded = None   # {read id: its lanes}, while align runs

    def seed_one(self, rid, read):
        return (Reference._lanes_mesh(self, rid, read) if self.path == "mesh"
                else Reference._lanes_single(self, rid, read))

    def _lanes_mesh(self, rid, read):
        return self._seeded[rid]

    def _lanes_single(self, rid, read):
        return self._seeded[rid]

    def align(self, reads, rids) -> dict:
        todo = [r for r in rids
                if reads.size(r) <= self.cfg["max_read_len"]]
        t0 = time.perf_counter()
        _SHARED.update(ref=self, reads=reads)
        try:
            with ProcessPoolExecutor(
                    self.workers,
                    mp_context=multiprocessing.get_context("fork")) as pool:
                self._seeded = dict(zip(todo, pool.map(_seed_one, todo)))
        finally:
            _SHARED.clear()
        self.times["seed_pool"] = time.perf_counter() - t0
        try:
            return super().align(reads, rids)
        finally:
            self._seeded = None


class Job(align_reads.Job):
    def reference(self, device) -> Reference:
        return PooledReference(self.target, self.traffic["aligner"],
                               self.path, device=device)
