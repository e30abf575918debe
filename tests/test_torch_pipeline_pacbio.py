"""The port's pipeline on the CPU against the JAX package's on the CPU, on
the PacBio 6 kb dataset of tests/test_pipeline.py (indel-dominant 13%
error, repeats, chimeras) with small_cfg's values: every file both write
must be byte-identical (tests/_torch_pipe.py), with the merge and
consensus switches at their defaults and at ``device``; run directories
are removed once compared.  A file of its own so that ``--dist loadfile``
runs it beside tests/test_torch_pipeline.py."""

import torch

from tests import _torch_pipe as tp
from tests.synth import make_dataset

torch.set_num_threads(1)


def _dataset():
    return make_dataset(seed=33, genome_len=6000, coverage=16,
                        mean_read=1000, read_err=0.13, n_contigs=2,
                        contig_gap=350, profile="pacbio", repeat_frac=0.12,
                        chimera=0.03)


def _runs_equal(tmp_path):
    ds = _dataset()
    with tp.removed(tmp_path / "jax", tmp_path / "torch"):
        res = {pkg: tp.run(pkg, ds, str(tmp_path / pkg))
               for pkg in ("jax", "torch")}
        assert res["torch"].stats["n_chains"] >= 1
        assert tp.differing(str(tmp_path / "jax" / "out"),
                            str(tmp_path / "torch" / "out")) == []


def test_pacbio_files_equal_jax(tmp_path):
    _runs_equal(tmp_path)


def test_pacbio_device_switches_files_equal_jax(tmp_path, monkeypatch):
    """Both packages with their merge and consensus switches at
    ``device`` (the port's on the CPU, the run's device): every file is
    still byte-identical."""
    for var in ("ALIGNGRAPH2_TPU_MERGE", "ALIGNGRAPH2_TPU_CONSENSUS",
                "ALIGNGRAPH2_TPU_TORCH_MERGE",
                "ALIGNGRAPH2_TPU_TORCH_CONSENSUS"):
        monkeypatch.setenv(var, "device")
    _runs_equal(tmp_path)
