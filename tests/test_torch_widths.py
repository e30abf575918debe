"""The band widths and bin counts past the defaults, through the port's
entry points on the CPU, against the JAX package: LongReadAligner at
band_width 32 and 2048 on the 6 kb dataset of tests/test_pipeline.py (.ref
text equal to the JAX package's CPU aligner), and the mesh path at
band_width 32 on blocks long enough that the seeder's bins pass one
block's shared memory (~21,900 bins; .ref text equal to the JAX mesh path
on 8 virtual devices, for port meshes 1x1 and 4x2).  And the domain the
card's kernels take: PipelineConfig.validate holds band_width to a power
of two from 16 to 4096 on cuda only."""

import dataclasses

import numpy as np
import pytest
import torch

from aligngraph2_tpu.align import aligner as jal
from aligngraph2_tpu.config import AlignerConfig as JConfig
from aligngraph2_tpu.io.seqdb import SeqDatabase as JDB
from aligngraph2_tpu_torch.align import aligner as tal
from aligngraph2_tpu_torch.config import (AlignerConfig, PipelineConfig,
                                          RuntimeConfig)
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase as TDB
from aligngraph2_tpu_torch.parallel import sharded as tsh
from aligngraph2_tpu_torch.parallel.mesh import make_mesh
from tests.synth import make_dataset

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.mark.parametrize("band_width", [16, 32, 256, 2048, 4096])
def test_validate_takes_the_kernels_widths_on_cuda(band_width):
    """Every power of two from 16 to 4096 passes on cuda and on the CPU."""
    for device in ("cuda", "cpu"):
        cfg = PipelineConfig(aligner=AlignerConfig(band_width=band_width),
                             runtime=RuntimeConfig(device=device))
        cfg.validate()


@pytest.mark.parametrize("band_width", [8, 48, 8192])
def test_validate_refuses_other_widths_on_cuda_only(band_width):
    """band_width 8, 48 and 8192 raise on cuda, naming the range, and pass
    on the CPU, which runs any width (as the JAX package does)."""
    cfg = PipelineConfig(aligner=AlignerConfig(band_width=band_width),
                         runtime=RuntimeConfig(device="cuda"))
    with pytest.raises(ValueError, match="power of two from 16 to 4096"):
        cfg.validate()
    cfg.runtime.device = "cpu"
    cfg.validate()


@pytest.fixture(scope="module")
def dataset():
    """tests/test_pipeline.py's 6 kb dataset."""
    return make_dataset(seed=21, genome_len=6000, coverage=14,
                        mean_read=1000, read_err=0.02, n_contigs=2,
                        contig_gap=350)


def _cfg(band_width):
    """tests/test_pipeline.py's aligner settings at ``band_width``."""
    return JConfig(band_width=band_width, min_aln_len=150, min_block_hits=3,
                   seed_k=11, delta=0.5)


@pytest.mark.parametrize("band_width", [32, 2048])
@pytest.mark.parametrize("target", ["contigs", "similar"])
def test_aligner_at_band_width_equals_jax(dataset, band_width, target):
    """Read -> contig and read -> similar genome on the CPU (the adaptive
    band at W = band_width in both packages): .ref text equal."""
    cfg = _cfg(band_width)
    recs = dataset[target]
    want = jal.LongReadAligner(JDB(recs), cfg, use_pallas=False) \
        .align_reads(JDB(dataset["reads"]))
    got = tal.LongReadAligner(TDB(recs), AlignerConfig(
        **dataclasses.asdict(cfg)), device="cpu").align_reads(
            TDB(dataset["reads"]))
    assert want.to_ref_text().count("\n") > 60
    assert got.to_ref_text() == want.to_ref_text()


# the mesh seeder at band_width 32 (bin_w 32) on 700,032 bp blocks: past
# the 19,348 bins of one block's shared memory on the card
WIDE = dict(band_width=32, min_aln_len=100, min_block_hits=3,
            max_candidates=4, seed_k=11, delta=0.5, block_size=700_000)


@pytest.fixture(scope="module")
def wide_dataset():
    return make_dataset(seed=9, genome_len=700_000, coverage=0.12,
                        mean_read=1000, read_err=0.03)


@pytest.fixture(scope="module")
def jax_wide_text(wide_dataset):
    from aligngraph2_tpu.parallel.mesh import make_mesh as jmesh
    alns = jal.LongReadAligner(
        JDB([("g", wide_dataset["genome"])]), JConfig(**WIDE),
        mesh=jmesh(8, block_parallel=2)).align_reads(
            JDB(wide_dataset["reads"]))
    assert len(alns) > 40
    return alns.to_ref_text()


@pytest.mark.parametrize("data, block", [(1, 1), (4, 2)])
def test_mesh_path_past_the_shared_bins_equals_jax(wide_dataset,
                                                   jax_wide_text, data,
                                                   block):
    """The mesh path at band_width 32 on 700 kb blocks: the seeder's bins
    pass one block's shared memory (the card's scratch layout) at every
    bucket of the reads, and the .ref text equals the JAX mesh path's."""
    al = tal.LongReadAligner(
        TDB([("g", wide_dataset["genome"])]), AlignerConfig(**WIDE),
        mesh=make_mesh(devices=[CPU] * (data * block), block_parallel=block))
    al._ensure_sharded_index()
    BL = al._block_index.block_len
    reads = TDB(wide_dataset["reads"])
    for NQ in {tal._bucket(reads.size(r)) for r in range(len(reads))}:
        nbins = int(np.ceil((BL + NQ) / 32)) + 2
        assert nbins > 19_348 and tsh.seed_bins_in_scratch(nbins)
    assert al.align_reads(reads).to_ref_text() == jax_wide_text
