"""The port's eight-stage pipeline (aligngraph2_tpu_torch/pipeline/driver.py)
and its CLI on the CPU against the JAX package's pipeline on the CPU, on
the legacy 6 kb dataset of tests/test_pipeline.py with small_cfg's values
(tests/_torch_pipe.py).  Each package runs in its own directory; every
file both write (the five outputs, every .ref, the solid set, config.txt,
coninfo, cor.fasta, the per-group files) must be byte-identical."""

import json
import os

import pytest
import torch

from aligngraph2_tpu_torch import cli
from tests import _torch_pipe as tp
from tests.synth import make_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ds = make_dataset(seed=21, genome_len=6000, coverage=14, mean_read=1000,
                      read_err=0.02, n_contigs=2, contig_gap=350)
    root = tmp_path_factory.mktemp("legacy")
    res = {pkg: tp.run(pkg, ds, str(root / pkg)) for pkg in ("jax", "torch")}
    return ds, root, res


def test_files_equal_jax(runs):
    _, root, res = runs
    assert res["torch"].stats["n_chains"] >= 1
    assert tp.differing(str(root / "jax" / "out"),
                        str(root / "torch" / "out")) == []
    with open(root / "jax" / "out" / "metrics.json") as f:
        want = set(json.load(f)) - {"mesh"}
    with open(root / "torch" / "out" / "metrics.json") as f:
        assert set(json.load(f)) == want | {"device"}


def test_second_run_reuses_every_stage(runs, tmp_path):
    ds, root, res = runs
    msgs = []
    cfg = tp.small_cfg("torch")
    cfg.runtime.profile_dir = str(tmp_path / "trace")
    again = tp.run("torch", ds, str(root / "torch"), cfg, log=msgs.append)
    joined = "\n".join(map(str, msgs))
    # k-mers, three aligner stages, grouping, the group, stage 7, stage 8
    assert joined.count("Reuse") >= 8, joined
    assert again.stats["reused_groups"] == again.stats["n_groups"] >= 1
    assert tp.differing(str(root / "jax" / "out"),
                        str(root / "torch" / "out")) == []
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_cli_device_cpu_equals_jax(runs, tmp_path):
    """The CLI with flags only: its final.fasta equals the JAX package's
    run with the configuration the flags map to."""
    ds, _, _ = runs
    paths = tp.inputs(ds, str(tmp_path))
    argv = ["-r", paths[0], "-c", paths[1], "-g", paths[2], "-o",
            str(tmp_path / "cli"), "-k", "12", "-t", "2", "--device", "cpu"]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert cfg.runtime.device == "cpu" and cfg.graph.k == 12
    assert cli.main(argv) == 0
    jcfg = tp.jax_cfg_like(cfg)
    jcfg.runtime.progress = False
    from aligngraph2_tpu.pipeline.driver import run_pipeline
    run_pipeline(*paths, str(tmp_path / "jax"), jcfg, log=lambda *a: None)
    got = (tmp_path / "cli" / "final.fasta").read_bytes()
    assert got and got == (tmp_path / "jax" / "final.fasta").read_bytes()


def test_no_cuda_is_an_error(runs, tmp_path, monkeypatch, capsys):
    """Without CUDA and without --device cpu the CLI exits nonzero and
    run_pipeline raises; neither falls back to the CPU."""
    ds, _, _ = runs
    paths = tp.inputs(ds, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    rc = cli.main(["-r", paths[0], "-c", paths[1], "-g", paths[2],
                   "-o", str(out)])
    assert rc != 0 and "--device cpu" in capsys.readouterr().err
    assert not out.exists()
    from aligngraph2_tpu_torch.config import PipelineConfig
    from aligngraph2_tpu_torch.pipeline.driver import run_pipeline
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pipeline(*paths, str(out), PipelineConfig())
    assert not out.exists()
