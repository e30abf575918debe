"""The port never loads JAX or the JAX package.

tests/conftest.py imports jax into every test process, so the import check
runs in a fresh interpreter."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import aligngraph2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
# the device paths import more inside their functions: run them once
import numpy as np
from aligngraph2_tpu_torch.consensus import device as cd
from aligngraph2_tpu_torch.graph import merge_device as md
md.merge_positions_device(*(np.array([1, 1]),) * 4, 10, "cpu")
md.merge_edges_device(*(np.array([1, 1]),) * 3, 2, "cpu")
cd.window_consensus_via_device(["ACGT"], [[(1, "AGGT", "ACGT", 1)]],
                               device="cpu")
cd.consensus_backbone_device("ACGTACGT", [], 4, 2, 2, 0, 1, device="cpu")
# the mesh path, multi-process helpers and the link probe, once each
import torch
from aligngraph2_tpu_torch.align.aligner import LongReadAligner
from aligngraph2_tpu_torch.config import AlignerConfig
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
from aligngraph2_tpu_torch.parallel import distributed as dd, make_mesh
from aligngraph2_tpu_torch.utils import devprobe
g = "ACGTTGCAAGGCTTACGATCGATCGGATCCTAGGCTAGCTAGGATCCATGCATGCCGTA" * 20
mesh = make_mesh(devices=[torch.device("cpu")] * 2)
LongReadAligner(SeqDatabase([("g", g)]), AlignerConfig(band_width=64),
                mesh=mesh).align_reads(SeqDatabase([("r", g[100:700])]))
dd.init_distributed()
assert dd.gather_host_bytes(b"x") == [b"x"]
assert devprobe.resolve_backend("ALIGNGRAPH2_TPU_TORCH_MERGE", "cpu")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "aligngraph2_tpu" or m.startswith("aligngraph2_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
# the device merge and consensus, and the modules they bring
assert {pkg.__name__ + "." + m for m in (
    "graph.merge_device", "consensus.device", "consensus.reduced",
    "consensus.native", "utils.transfer", "utils.segment",
    "utils.backend", "utils.devprobe", "parallel.mesh", "parallel.sharded",
    "parallel.distributed", "ops.banded_dp", "ops._cuda")} <= set(names), names
"""


def test_port_modules_load_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _sources():
    for base, _, files in os.walk(os.path.join(ROOT, "aligngraph2_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("pattern", [r"\bimport jax\b", r"\bfrom jax\b",
                                     r"aligngraph2_tpu\."])
def test_port_sources_name_no_jax(pattern):
    hits = []
    for path in _sources():
        with open(path) as f:
            for n, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{n}")
    assert not hits, hits
