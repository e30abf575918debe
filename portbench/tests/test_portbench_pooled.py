"""The pooled check (``jobs/align_reads_pooled.py``): its reference gives
the plain reference's records read for read, a tiny job through it is
correct, and a fault in the program still comes out not correct."""

import copy
import time

import pytest
import torch

from portbench import deployment, harness
from portbench.jobs.align_reads_pooled import PooledReference
from portbench.reference.align import Reference

from .conftest import tiny_spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 7


def pooled_spec(path):
    spec = tiny_spec(path)
    spec["traffic"] = dict(copy.deepcopy(spec["traffic"]),
                           job="align_reads_pooled")
    return spec


def devices(path):
    return [CPU, CPU] if path == "mesh" else [CPU]


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_pooled_reference_equals_reference(monkeypatch, path):
    monkeypatch.setattr(PooledReference, "workers", 3)
    spec = tiny_spec(path)
    tr = spec["traffic"]
    dep = deployment.build(spec["config"], SEED, tr["pool_coverage"],
                           {tr["target"], "reads"})
    rids = list(range(len(dep["reads"])))
    args = (dep[tr["target"]], tr["aligner"], path)
    want = Reference(*args).align(dep["reads"], rids)
    ref = PooledReference(*args)
    assert ref.align(dep["reads"], rids) == want
    assert sum(len(v) for v in want.values()) >= 8
    assert ref.times["seed_pool"] > 0 and ref._seeded is None


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_tiny_pooled_job_matches_reference(path):
    res = harness.run(pooled_spec(path), SEED, 0.5, False, devices(path),
                      time.perf_counter())
    assert res["correct"], res["check"]
    assert res["check"]["reads_checked"]["value"] >= 16


def test_pooled_check_sees_an_altered_answer(monkeypatch):
    import aligngraph2_tpu_torch.align.aligner as al
    real = al.moves_to_strings

    def flipped(*a):
        q, t, qe, te = real(*a)
        return ("T" if q[:1] != "T" else "A") + q[1:], t, qe, te

    monkeypatch.setattr(al, "moves_to_strings", flipped)
    res = harness.run(pooled_spec("mesh"), SEED, 0.5, False,
                      devices("mesh"), time.perf_counter())
    assert not res["correct"]
