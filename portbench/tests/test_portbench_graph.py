"""The graph-stages job (``jobs/graph_stages.py``) end to end on the CPU at a
tiny size: stages 6-8 rerun from the stage cache and checked against the
plain references; each fault the cell can have, planted in the program,
makes the run not correct; the frozen merge equals every route of the
port's merges.  Also: the harness's ``parts``, job ``check()`` and
``job_reads: "all"`` leave the aligner cells as they were."""

import copy
import time

import numpy as np
import pytest
import torch

from portbench import control_graph, deployment, harness
from portbench.jobs import align_reads, graph_stages
from portbench.reference import merge as ref_merge

from .conftest import tiny_spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 5
PER_LAYER = ["pagraph_ms_per_kread", "align_split_ms_per_kread",
             "correct_ms_per_kread", "device_idle_pct"]


def tiny_graph_spec() -> dict:
    """The cell's traffic on a 10 kb chromosome with 2 draft contigs, reads
    of 1 kb mean at 16x (155 reads), and the pipeline tests' small-data
    settings (k = 12, a 2 kb consensus window)."""
    cfg = copy.deepcopy(harness.read_json("configs", "ecoli_k12_pacbio"))
    cfg["genome"]["chromosomes"] = [["c1", 10000]]
    cfg["genome"]["repeats"]["repeat_frac"] = 0.12
    cfg["contigs"].update(count=2, gap=350)
    cfg["reads"].update(mean_len=1000, chimera=0.03)
    tr = copy.deepcopy(harness.read_json("traffic", "graph.single"))
    tr["aligner"].update(band_width=128, min_aln_len=150, min_block_hits=3,
                         seed_k=11, delta=0.5, chunk_len=1500)
    tr.update(pool_coverage=16, graph={"k": 12, "solid_threshold": 0.05},
              consensus={"window": 2000, "top_k": 200},
              runtime={"threads": 2},
              check={"reads": 16, "longest": 2, "all_above": 65536})
    names = ["reads_per_s", "setup_s"]
    return {"name": "tiny.graph", "chips": 1, "config": cfg, "traffic": tr,
            "end_to_end": names, "per_layer": PER_LAYER,
            "units": dict.fromkeys(names + PER_LAYER, "x")}


def run(spec, trace=False):
    return harness.run(spec, SEED, 0.5, trace, [CPU], time.perf_counter())


@pytest.fixture
def merge_on_device(monkeypatch):
    """The device merges on the CPU: ``auto`` resolves to the native core
    there, and the check wants merge calls to compare."""
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", "device")


@pytest.fixture
def in_window(monkeypatch):
    """A dict whose "on" is true while a job after the warm-up runs."""
    state = {"on": False}
    real = graph_stages.Job.run

    def job_run(self, ids):
        state["on"] = self.first is not None
        return real(self, ids)

    monkeypatch.setattr(graph_stages.Job, "run", job_run)
    return state


# ---- the aligner cells are read as before ----

@pytest.mark.parametrize("cell", ["scer.r2r.mesh1", "scer.r2r.mesh4"])
def test_aligner_cells_build_what_they_built(cell, monkeypatch):
    """The parts each aligner cell builds, its traffic and its metrics."""
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    tr = spec["traffic"]
    assert "parts" not in tr and isinstance(tr["job_reads"], int)
    assert tr["job"] == "align_reads" and tr["target"] == "similar"
    assert spec["end_to_end"] == ["reads_per_s", "setup_s"]
    assert not set(spec["per_layer"]) & {"pagraph_ms_per_kread",
                                          "align_split_ms_per_kread",
                                          "correct_ms_per_kread"}
    assert "device_idle_pct" in spec["per_layer"]
    seen = []

    def build(config, seed, coverage, parts):
        seen.append(set(parts))
        raise KeyboardInterrupt

    monkeypatch.setattr(deployment, "build", build)
    with pytest.raises(KeyboardInterrupt):
        harness.run(spec, SEED, 1, False, [CPU], time.perf_counter())
    assert seen == [{"similar", "reads"}]


def test_aligner_job_check_keys_unchanged():
    assert not hasattr(align_reads.Job, "check")
    res = harness.run(tiny_spec("single"), SEED, 0.5, False, [CPU],
                      time.perf_counter())
    assert list(res["check"]) == [
        "reads_checked", "reads_differing", "headers_differing",
        "strings_differing", "records_missing", "records_extra",
        "jobs_failed"]


# ---- the graph job ----

def test_graph_job_reruns_stages_6_to_8_and_is_correct(merge_on_device):
    res = run(tiny_graph_spec(), trace=True)
    chk = res["check"]
    assert res["correct"], chk
    assert list(chk)[-4:] == ["merge_calls_checked", "merge_calls_differing",
                              "outputs_differing", "n_chains"]
    assert chk["merge_calls_checked"]["value"] == 4   # 2 passes x 2 merges
    assert chk["n_chains"]["value"] >= 1
    assert chk["reads_checked"]["value"] >= 16
    assert res["attempted"] == 155 and res["failed"] == 0
    for name in PER_LAYER[:3]:
        assert res["metrics"][name]["value"] > 0


def test_graph_job_counts_the_rerun():
    """The counters of a later job: stage walls, chains, backends."""
    spec = tiny_graph_spec()
    dep = deployment.build(spec["config"], SEED, 16,
                           spec["traffic"]["parts"])
    job = graph_stages.Job(dep, spec["traffic"], [CPU])
    try:
        ids = job.warmup_ids("all")
        job.run(ids)
        before = job.counters()
        out = job.run(ids)
        delta = {k: v - before[k] for k, v in job.counters().items()}
        assert all(delta[f"stage_s.{s}"] > 0 for s in graph_stages.STAGES)
        assert delta["n_chains"] >= 1
        assert delta["merge.native"] == 1 and delta["consensus.native"] == 1
        assert job.texts(out, set(dep["reads"].names))
        with pytest.raises(ValueError):
            job.run(ids[1:])
    finally:
        job.close()


# ---- faults planted in the program ----

def test_merge_output_altered(merge_on_device, monkeypatch):
    """One count of the device positions merge off by one: the kept call
    differs from the frozen merge."""
    from aligngraph2_tpu_torch.graph import merge_device
    real = merge_device.merge_positions_device

    def off_by_one(*args):
        node, ctg, ref, cnt = real(*args)
        cnt = cnt.copy()
        cnt[len(cnt) // 2] += 1
        return node, ctg, ref, cnt

    monkeypatch.setattr(merge_device, "merge_positions_device", off_by_one)
    res = run(tiny_graph_spec())
    assert not res["correct"]
    assert res["check"]["merge_calls_differing"]["value"] >= 1


def test_window_add_fasta_altered(merge_on_device, in_window, monkeypatch):
    """A window job's corrected backbone differs in one base from the
    warm-up's (``add.fasta``, ``final.fasta``, ``cor.fasta``)."""
    from aligngraph2_tpu_torch.pipeline import driver
    real = driver.consensus_backbone

    def altered(seq, *a, **kw):
        cns = real(seq, *a, **kw) or seq
        if in_window["on"]:
            cns = ("A" if cns[0] != "A" else "C") + cns[1:]
        return cns

    monkeypatch.setattr(driver, "consensus_backbone", altered)
    res = run(tiny_graph_spec())
    assert not res["correct"]
    assert res["check"]["outputs_differing"]["value"] >= 1


def test_window_job_left_unchanged(merge_on_device, monkeypatch):
    """A job that removes no marker returns the cached state: stages 6-8
    reused, the job fails."""
    monkeypatch.setattr(graph_stages, "RERUN_MARKERS", ())
    res = run(tiny_graph_spec())
    assert not res["correct"]
    assert res["check"]["jobs_failed"]["value"] >= 1


def test_window_half_the_reads_left_out(merge_on_device, in_window,
                                        monkeypatch):
    """Stage 7 aligns every other read in the window."""
    from aligngraph2_tpu_torch.align.aligner import LongReadAligner
    real = LongReadAligner.align_reads

    def half(self, read_db, ids=None, **kw):
        if in_window["on"]:
            ids = list(range(len(read_db)))[::2]
        return real(self, read_db, ids=ids, **kw)

    monkeypatch.setattr(LongReadAligner, "align_reads", half)
    res = run(tiny_graph_spec())
    assert not res["correct"]
    assert res["check"]["records_missing"]["value"] > 0


def test_window_strings_altered(merge_on_device, in_window, monkeypatch):
    """Stage 7's gapped strings altered where they are made."""
    import aligngraph2_tpu_torch.align.aligner as al
    real = al.moves_to_strings

    def flipped(*a):
        q, t, qe, te = real(*a)
        if in_window["on"]:
            q = ("T" if q[:1] != "T" else "A") + q[1:]
        return q, t, qe, te

    monkeypatch.setattr(al, "moves_to_strings", flipped)
    res = run(tiny_graph_spec())
    assert not res["correct"]
    assert res["check"]["strings_differing"]["value"] > 0


def test_band_half_control_comes_out_not_correct(merge_on_device):
    """The control: stage 7's reference with half the band in the
    program's place, over the backbones of the program's set-up, with
    reads of 6 kb mean (8x) whose indels drift past a quarter of the
    band."""
    spec = tiny_graph_spec()
    spec["config"]["reads"]["mean_len"] = 6000
    spec["traffic"]["pool_coverage"] = 8
    [out] = control_graph.control(spec, 2 ** 31 + 7, CPU)
    assert not out["correct"], out
    assert out["check"]["reads_differing"]["value"] > 0


# ---- the frozen merge ----

def _graph_arrays(seed: int):
    rng = np.random.default_rng(seed)
    n = 20000
    node = rng.integers(0, 300, n).astype(np.int32)
    # coordinates near one another, with zeros, so clusters form
    ctg = (rng.integers(0, 60, n) * 7 * (rng.random(n) > 0.1)).astype(
        np.uint32)
    ref = (rng.integers(0, 60, n) * 7 * (rng.random(n) > 0.1)).astype(
        np.uint32)
    cnt = rng.integers(1, 40000, n).astype(np.uint16)
    frm = rng.integers(0, 200, n).astype(np.int32)
    to = rng.integers(0, 200, n).astype(np.int32)
    step = rng.integers(1, 4, n).astype(np.int32)
    return (node, ctg, ref, cnt), (frm, to, step)


@pytest.mark.parametrize("route", ["numpy", "native", "device"])
def test_frozen_merge_equals_the_ports_routes(route, monkeypatch):
    """The frozen merge equals ``PAGraph.merge_positions`` and
    ``merge_edges`` on seeded arrays through each route of the switch
    (``device`` on the CPU)."""
    from aligngraph2_tpu_torch.graph.pagraph import PAGraph
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", route)
    for seed in (1, 2):
        pos, edges = _graph_arrays(seed)
        g = PAGraph(np.arange(300, dtype=np.int64), 6, device="cpu")
        g.pos_node, g.pos_ctg, g.pos_ref, g.pos_count = pos
        g.edge_from, g.edge_to, g.edge_step = edges
        g.merge_positions(10)
        g.merge_edges()
        want = ref_merge.merge_positions(*pos, epsilon=10)
        assert (want[3] == 0xFFFF).any() and len(want[0]) < len(pos[0])
        assert graph_stages.same_arrays(
            want, (g.pos_node, g.pos_ctg, g.pos_ref, g.pos_count))
        assert graph_stages.same_arrays(
            ref_merge.merge_edges(*edges),
            (g.edge_from, g.edge_to, g.edge_step))
