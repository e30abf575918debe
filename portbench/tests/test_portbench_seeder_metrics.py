"""The readers of the mesh seeder's counters (``seed.read_blocks``,
``select.candidates``, ``seed.selected``) against the kernels' device time,
on a hand-made trace and registry: each one's value, and None where its
counter or kernel is missing (as on a program without them)."""

import pytest

from aligngraph2_tpu_torch.utils import timing
from portbench import harness

COUNTS = {"seed.read_blocks": 2_000_000, "select.candidates": 5_000_000,
          "seed.selected": 24_000}
OPS = {"void seed_block_kernel<false>(...)": 0.5,
       "void select_candidates_kernel<false>(...)": 0.01,
       "dp_adaptive_kernel": 9.0}
NAMES = {"seed_block_ns_per_pair": ("seed.read_blocks", "seed_block_kernel"),
         "select_ns_per_candidate": ("select.candidates",
                                     "select_candidates_kernel"),
         "candidates_per_read": ("seed.selected", None)}


def ctx(ops=OPS):
    return {"units": 4000, "window_s": 20.0, "devices": 1, "counters": {},
            "trace": {"spans_s": {}, "ops_s": dict(ops), "busy_s": {},
                      "window_s": 20.0}}


@pytest.fixture
def registry(monkeypatch):
    """The program's registry, holding ``COUNTS``."""
    monkeypatch.setattr(timing, "_counts", dict(COUNTS))


@pytest.mark.parametrize("name, want", [
    # kernel ns over the counter: 0.5e9 / 2e6, 0.01e9 / 5e6; 24,000 / 4,000
    ("seed_block_ns_per_pair", 250.0),
    ("select_ns_per_candidate", 2.0),
    ("candidates_per_read", 6.0),
])
def test_reader(registry, name, want):
    assert harness.reader(name)(ctx()) == pytest.approx(want)


@pytest.mark.parametrize("name", list(NAMES))
def test_counter_missing_gives_nothing(monkeypatch, name):
    missing = NAMES[name][0]
    monkeypatch.setattr(timing, "_counts", {k: v for k, v in COUNTS.items()
                                            if k != missing})
    assert harness.reader(name)(ctx()) is None


@pytest.mark.parametrize("name", list(NAMES))
def test_program_without_registry_gives_nothing(monkeypatch, name):
    monkeypatch.delattr(timing, "counts")
    assert harness.reader(name)(ctx()) is None


@pytest.mark.parametrize("name", [n for n, (_, k) in NAMES.items() if k])
def test_kernel_missing_gives_nothing(registry, name):
    """No time of the kernel in the trace (or no trace): nothing to read."""
    kernel = NAMES[name][1]
    ops = {k: v for k, v in OPS.items() if kernel not in k}
    assert harness.reader(name)(ctx(ops=ops)) is None
    assert harness.reader(name)(dict(ctx(), trace=None)) is None
