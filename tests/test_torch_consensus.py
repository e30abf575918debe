"""The port's windowed consensus (aligngraph2_tpu_torch/consensus/) on the
CPU against the JAX package's: one noisy 6 kb backbone and the reads of
the legacy pipeline dataset aligned to it by the JAX package's
single-device aligner (records cross over as .ref text).  The consensus
must be equal, exactly, through the native core, through the Python spec
and through the device aggregation on the CPU; an unknown backend must
raise."""

import numpy as np
import pytest
import torch

from aligngraph2_tpu_torch.align.records import AlignmentSet as TSet
from aligngraph2_tpu_torch.config import ConsensusConfig as TConfig
from aligngraph2_tpu_torch.consensus.window import consensus_backbone
from tests import _torch_group as tg
from tests.synth import mutate

torch.set_num_threads(1)

WINDOW, TOP_K = 2000, 200   # tests/test_pipeline.py small_cfg's values


@pytest.fixture(scope="module")
def backbone_case():
    """(backbone, .ref text, the JAX package's consensus)."""
    from aligngraph2_tpu.align.aligner import LongReadAligner
    from aligngraph2_tpu.config import ConsensusConfig
    from aligngraph2_tpu.consensus.window import consensus_backbone as jcb
    from aligngraph2_tpu.io.seqdb import SeqDatabase
    ds = tg.dataset()
    rng = np.random.default_rng(5)
    backbone = mutate(rng, ds["genome"], 0.03, 0.01, 0.01)
    alns = LongReadAligner(SeqDatabase([("bb", backbone)]),
                           tg.jax_aligner_cfg(), use_pallas=False
                           ).align_reads(SeqDatabase(ds["reads"]))
    want = jcb(backbone, alns, ConsensusConfig(window=WINDOW, top_k=TOP_K),
               threads=2)
    return backbone, alns.to_ref_text(), want


@pytest.mark.parametrize("backend", ["native", "spec"])
def test_consensus_equals_jax(backbone_case, monkeypatch, backend):
    backbone, text, want = backbone_case
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_CONSENSUS", backend)
    if backend == "native":
        from aligngraph2_tpu_torch.consensus.native import get_lib
        assert get_lib() is not None, "native/poacns.cpp did not build"
    alns = TSet.from_ref_text(text)
    assert len(alns) > 50
    got = consensus_backbone(backbone, alns,
                             TConfig(window=WINDOW, top_k=TOP_K), threads=2)
    assert got != backbone and abs(len(got) - len(backbone)) < 500
    assert got == want


def test_device_consensus_raises(backbone_case, monkeypatch):
    """``device`` is a consensus backend now (on the caller's device, here
    the CPU) and equals the JAX package's consensus; a value that names no
    backend raises."""
    backbone, text, want = backbone_case
    cfg = TConfig(window=WINDOW, top_k=TOP_K)
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_CONSENSUS", "device")
    assert consensus_backbone(backbone, TSet.from_ref_text(text), cfg,
                              threads=2, device="cpu") == want
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_CONSENSUS", "gpu")
    with pytest.raises(ValueError, match="expected one of native, device"):
        consensus_backbone(backbone, TSet.from_ref_text(text), cfg)
