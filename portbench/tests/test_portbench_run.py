"""A tiny job end to end on the CPU against the plain reference, on both
paths; the same run with the timed path broken underneath, and the
control, must come out not correct."""

import time

import pytest
import torch

from portbench import control, harness

from .conftest import tiny_spec

CPU = torch.device("cpu")


def run(spec, devices, seed=2 ** 31 + 5):
    return harness.run(spec, seed, 0.5, False, devices, time.perf_counter())


def devices(path):
    return [CPU, CPU] if path == "mesh" else [CPU]


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_tiny_job_matches_reference(path):
    res = run(tiny_spec(path), devices(path))
    assert res["correct"], res["check"]
    assert res["check"]["reads_checked"]["value"] >= 16
    assert res["attempted"] >= 16 and res["failed"] == 0
    assert set(res["metrics"]) == {"reads_per_s", "setup_s"}
    assert list(res)[-1] == "check"


def test_records_are_compared(monkeypatch):
    """The tiny job has records to compare: the comparison sees them."""
    seen = []
    real = harness.compare

    def spy(got, want, names):
        seen.append(sum(len(v) for v in want.values()))
        return real(got, want, names)

    monkeypatch.setattr(harness, "compare", spy)
    run(tiny_spec("single"), devices("single"))
    assert seen and seen[0] >= 8


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_answer_altered_where_produced(monkeypatch, path):
    import aligngraph2_tpu_torch.align.aligner as al
    real = al.moves_to_strings

    def flipped(*a):
        q, t, qe, te = real(*a)
        return ("T" if q[:1] != "T" else "A") + q[1:], t, qe, te

    monkeypatch.setattr(al, "moves_to_strings", flipped)
    res = run(tiny_spec(path), devices(path))
    assert not res["correct"]
    assert res["check"]["strings_differing"]["value"] > 0


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_half_the_batch_left_out(monkeypatch, path):
    from portbench.jobs import align_reads
    real = align_reads.Job.run
    monkeypatch.setattr(align_reads.Job, "run",
                        lambda self, ids: real(self, ids[:len(ids) // 2]))
    res = run(tiny_spec(path), devices(path))
    assert not res["correct"]
    assert res["check"]["records_missing"]["value"] > 0


def test_exchange_between_chips_left_out(monkeypatch):
    """The seeder's gather over the block shards keeps only the first
    shard's tables: reads of the second shard's blocks lose records."""
    import aligngraph2_tpu_torch.parallel.sharded as sh
    real = sh._seed_body
    monkeypatch.setattr(sh, "_seed_body",
                        lambda q_f, q_r, ln, row, **kw:
                        real(q_f, q_r, ln, row[:1], **kw))
    res = run(tiny_spec("mesh"), devices("mesh"))
    assert not res["correct"]


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_band_half_control_comes_out_not_correct(path):
    """The control: the reference with half the band in the program's
    place, on the tiny cell's whole sample, with reads of 6 kb mean whose
    indels drift past a quarter of the band."""
    spec = tiny_spec(path)
    spec["config"]["reads"]["mean_len"] = 6000
    [out] = control.control(spec, 2 ** 31 + 7, 16, CPU, kinds=["band_half"])
    assert not out["correct"], out
    assert out["check"]["reads_differing"]["value"] > 0


def test_int16_control_comes_out_not_correct():
    """Cell scores saturated at 32,767 on a read long enough to score past
    it (the adaptive band follows its indels): a 90 kb chromosome in one
    block, reads of 20 kb mean at 2% error on the mesh path, the longest
    checked as a read past ``all_above``."""
    spec = tiny_spec("mesh")
    spec["config"]["genome"]["chromosomes"] = [["c1", 90000]]
    spec["traffic"]["aligner"]["block_size"] = 100000
    spec["config"]["reads"].update(mean_len=20000, err=0.02, chimera=0.0)
    spec["traffic"].update(job_reads=4, check={"reads": 1, "longest": 0,
                                               "all_above": 17000})
    spec["traffic"]["path"]["mesh"] = [1, 1]
    [out] = control.control(spec, 2 ** 31 + 7, 4, CPU, kinds=["int16"])
    assert out["longest_read"] > 17000
    assert not out["correct"]
    assert out["check"]["headers_differing"]["value"] > 0


def test_sample_takes_every_read_past_all_above():
    """Every answered read longer than ``all_above`` (up to the longest
    the aligner takes) is checked, beyond the ``n_longest`` longest."""
    from portbench.deployment import seqs
    lens = [100, 70000, 200, 90000, 300, 50000, 80000, 400]
    reads = seqs([torch.zeros(n, dtype=torch.uint8).numpy() for n in lens],
                 [str(i) for i in range(len(lens))])
    s = harness.Sample(reads, 2 ** 31 + 9, 2, 1, 131072, 65536)
    s.keep([0, 1, 2, 3])
    s.keep([4, 5, 6, 7])
    pick = set(s.pick({0, 1, 2, 3, 4, 5, 6}))
    assert {1, 3, 6} <= pick and 7 not in pick
    assert pick - {1, 3, 6} <= set(s.drawn)
