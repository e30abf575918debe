"""The benchmark's files are found by name, and BENCHMARK.json keeps to
the rules a run relies on."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    spec = harness.cell_spec(BENCH, cell)
    assert spec["chips"] in (1, 4)
    assert callable(harness.job_class(spec["traffic"]["job"]))
    for name in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(name))
    assert "setup_s" in spec["end_to_end"] and len(spec["end_to_end"]) >= 2
    assert spec["per_layer"]


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[kind]}) == len(BENCH[kind])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files(cfg):
    c = next(c for c in BENCH["configs"] if c["name"] == cfg)
    path = os.path.join(harness.ROOT, c["file"])
    with open(path) as f:
        data = json.load(f)
    assert data["name"] == cfg and data["source"] == c["source"]
    assert data["reduced"] == c["reduced"]


def test_scer_chromosomes_are_s288c():
    cfg = harness.read_json("configs", "scer_s288c_pacbio")
    lens = [n for _, n in cfg["genome"]["chromosomes"]]
    assert len(lens) == 16 and sum(lens) == 12_071_326


def test_forbidden_names_compared_whole():
    f = harness.forbidden_modules
    assert f(["aligngraph2_tpu_torch", "aligngraph2_tpu_torch.ops",
              "jaxtyping", "flaxen.x", "portbench"]) == []
    assert f(["jax.numpy", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                        "jaxlib"]
    assert f(["aligngraph2_tpu.config", "aligngraph2_tpu_torch"]) == [
        "aligngraph2_tpu"]


def test_reference_imports_nothing_of_the_programs():
    ref_dir = os.path.join(harness.BENCH_DIR, "reference")
    for fn in os.listdir(ref_dir):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fn)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "aligngraph2_tpu",
                    "aligngraph2_tpu_torch"), (fn, m)


def test_run_loads_no_jax():
    """Importing the harness, the job and every reader loads neither JAX
    nor the JAX package (a fresh interpreter)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "b = harness.load_benchmark()\n"
            "for w in b['workloads']:\n"
            "    s = harness.cell_spec(b, w['name'])\n"
            "    harness.job_class(s['traffic']['job'])\n"
            "    [harness.reader(n) for n in s['end_to_end'] + s['per_layer']]\n"
            "import aligngraph2_tpu_torch.align.aligner\n"
            "import aligngraph2_tpu_torch.parallel.sharded\n"
            "print(harness.forbidden_modules())\n" % harness.ROOT)
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_cards(tmp_path):
    """Without enough CUDA cards run.py exits with another code than 0 and
    prints no result."""
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the cards")
    cell = next(w["name"] for w in BENCH["workloads"] if w["chips"] == 4)
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=harness.ROOT)
    assert out.returncode not in (0, None)
    assert out.stdout.strip() == ""
