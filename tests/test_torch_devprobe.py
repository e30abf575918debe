"""The port's link probe and the ``auto`` value of its backend switches
(aligngraph2_tpu_torch/utils/devprobe.py): the five cases of
tests/test_devprobe.py under the port's variable names and its consensus
rule (``auto`` keeps the native consensus at any link rate)."""

import pytest
import torch

from aligngraph2_tpu_torch.utils import devprobe

torch.set_num_threads(1)

MERGE = "ALIGNGRAPH2_TPU_TORCH_MERGE"
CONSENSUS = "ALIGNGRAPH2_TPU_TORCH_CONSENSUS"
LINK = "ALIGNGRAPH2_TPU_TORCH_LINK_MBPS"


@pytest.fixture(autouse=True)
def _switches_unset(monkeypatch):
    for var in (MERGE, CONSENSUS, LINK):
        monkeypatch.delenv(var, raising=False)


def test_auto_picks_device_on_fast_link(monkeypatch):
    """A fast link takes the device merge; the consensus stays native."""
    monkeypatch.setenv(LINK, "8000")
    assert devprobe.resolve_backend(MERGE, "cuda") == "device"
    assert devprobe.resolve_backend(CONSENSUS, "cuda") == "native"


def test_auto_picks_native_on_slow_link(monkeypatch):
    monkeypatch.setenv(LINK, "40")
    assert devprobe.resolve_backend(MERGE, "cuda") == "native"
    assert devprobe.resolve_backend(CONSENSUS, "cuda") == "native"


def test_explicit_env_beats_auto(monkeypatch):
    monkeypatch.setenv(LINK, "8000")
    monkeypatch.setenv(MERGE, "numpy")
    assert devprobe.resolve_backend(MERGE, "cuda") == "numpy"
    monkeypatch.setenv(MERGE, "native")
    assert devprobe.resolve_backend(MERGE, "cuda") == "native"
    monkeypatch.setenv(CONSENSUS, "device")
    assert devprobe.resolve_backend(CONSENSUS, "cuda") == "device"


@pytest.mark.parametrize("device", ["cpu", None])
def test_cpu_backend_measures_zero(monkeypatch, device):
    """On the CPU, and where no card is present, the probe answers 0
    without a copy, so ``auto`` is native for both switches."""
    monkeypatch.setattr(devprobe, "_cached_mbps", {})
    if device is None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert devprobe.link_bandwidth_mbps(device) == 0.0
    assert devprobe._cached_mbps == {}
    assert devprobe.resolve_backend(MERGE, device) == "native"
    assert devprobe.resolve_backend(CONSENSUS, device) == "native"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devprobe.measure_link(device or "cuda")


def test_merge_dispatch_respects_auto(monkeypatch):
    """End to end through PAGraph._merge_backend and consensus_backbone's
    switch: a fast fake link picks the device merge, a slow one the native
    core; both pick the native consensus.  The backends are bit-equal
    (tests/test_torch_merge_device.py), so only the choice is asserted."""
    import numpy as np
    from aligngraph2_tpu_torch.graph.pagraph import PAGraph
    from aligngraph2_tpu_torch.utils.backend import resolve_backend
    g = PAGraph(np.arange(16, dtype=np.int64), 4, device="cuda")
    monkeypatch.setenv(LINK, "8000")
    assert g._merge_backend() == "device"
    assert resolve_backend(CONSENSUS, ("native", "device", "spec"),
                           "cuda") == "native"
    monkeypatch.setenv(LINK, "40")
    assert g._merge_backend() == "native"
    monkeypatch.delenv(LINK)
    assert PAGraph(np.arange(16, dtype=np.int64), 4,
                   device="cpu")._merge_backend() == "native"
