"""Fixtures of the benchmark's CPU tests: tiny cells made from the real
configuration and traffic files, cut to a size the CPU runs in seconds.

Run: ``python -m pytest portbench/tests -q`` from the repository's root.
Tests marked ``card`` need a CUDA card; they skip without one (decided
inside the test)."""

import copy

import pytest

from portbench import harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def tiny_spec(path: str, **over) -> dict:
    """A cell of the given path ("single" or "mesh") on a genome of tens
    of kb: the ecoli deployment's profile on one 60 kb chromosome with 3
    contigs, or two chromosomes of 30 and 20 kb with 20 kb blocks on a
    1x2 mesh (two block shards), jobs of 16 reads, every read checked."""
    cfg = copy.deepcopy(harness.read_json("configs", "ecoli_k12_pacbio"))
    cfg["reads"]["mean_len"] = 1500
    if path == "mesh":
        cfg["genome"]["chromosomes"] = [["c1", 30000], ["c2", 20000]]
        tr = copy.deepcopy(harness.read_json("traffic", "r2r.mesh1x1"))
        tr["aligner"]["block_size"] = 20000
        tr["path"]["mesh"] = [1, 2]
    else:
        cfg["genome"]["chromosomes"] = [["c1", 60000]]
        cfg["contigs"].update(count=3, gap=500)
        tr = copy.deepcopy(harness.read_json("traffic", "r2c.single"))
    tr.update(job_reads=16, pool_coverage=1.0,
              check={"reads": 16, "longest": 2, "all_above": 65536})
    for k, v in over.items():
        (cfg if k in cfg else tr)[k] = v
    names = ["reads_per_s", "setup_s"]
    return {"name": f"tiny.{path}", "chips": 1, "config": cfg,
            "traffic": tr, "end_to_end": names, "per_layer": [],
            "units": {"reads_per_s": "reads/s", "setup_s": "s"}}


@pytest.fixture
def tiny():
    return tiny_spec
