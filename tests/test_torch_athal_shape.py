"""The mesh path at the shape of the A. thaliana deployment
(``portbench/configs/athal_tair10_pacbio.json``): five chromosomes, so many
blocks a read that the selection's table leaves the card's shared memory.

  * the configuration: TAIR10's five nuclear chromosomes, and the port's
    block rule on them at the cell's settings (795 blocks, N = 12,720
    candidates a read, the table past ``SELECT_SHARED_SLOTS``);
  * on the CPU, the port's mesh path against the plain reference
    (``portbench/reference/``), record for record, on an Arabidopsis-shaped
    deployment of 0.82 Mb in TAIR10's length ratios with blocks of 2,048
    (NB >= 513, so N = 2 NB K > 8,192): reads drawn from the seed, among
    them reads inside repeat copies;
  * on a card (skips without one): the seed step through
    ``make_sharded_seeder`` at the deployment's NB = 795 and N = 12,720,
    the kernels against the plain versions on the same card.  Run there
    with ``python -m pytest --noconftest tests/test_torch_athal_shape.py
    -q`` (``tests/conftest.py`` imports JAX, which a card's environment
    need not have).
"""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aligngraph2_tpu_torch.io.seqdb import SeqDatabase
from aligngraph2_tpu_torch.parallel import sharded
from aligngraph2_tpu_torch.parallel.mesh import make_mesh
from aligngraph2_tpu_torch.utils import timing
from portbench import deployment, harness, synth
from portbench.jobs.align_reads import Job
from portbench.reference.align import Reference

CONFIG = harness.read_json("configs", "athal_tair10_pacbio")
TRAFFIC = harness.read_json("traffic", "r2r.mesh1x1.pool2")
TAIR10 = {"Chr1": 30_427_671, "Chr2": 19_698_289, "Chr3": 23_459_830,
          "Chr4": 18_585_056, "Chr5": 26_975_502}
SMALL_BP = 820_000
SMALL_BLOCK = 2048


def _blocks(lengths, cfg):
    """The blocks of each sequence by the port's rule, at the traffic's
    seed_k, block_size and band_width."""
    BL = sharded.mesh_block_len(max(lengths), cfg["block_size"],
                                cfg["band_width"])
    return BL, [len(sharded.block_starts(n, cfg["seed_k"], BL, BL // 4))
                for n in lengths]


def test_config_is_tair10():
    chroms = CONFIG["genome"]["chromosomes"]
    assert dict(chroms) == TAIR10 and [c for c, _ in chroms] == list(TAIR10)
    assert sum(n for _, n in chroms) == 119_146_348
    assert CONFIG["reduced"] == ["reads"] and CONFIG["contigs"] is None
    # scer's traffic but for the pool and the check's pooled reference
    assert TRAFFIC["pool_coverage"] == 2
    assert TRAFFIC["job"] == "align_reads_pooled"
    scer = harness.read_json("traffic", "r2r.mesh1x1")
    differ = ("name", "about", "pool_coverage", "job")
    assert {k: v for k, v in TRAFFIC.items() if k not in differ} == \
        {k: v for k, v in scer.items() if k not in differ}


def test_port_block_rule_at_tair10():
    cfg = TRAFFIC["aligner"]
    BL, per_chrom = _blocks([n for _, n in CONFIG["genome"]["chromosomes"]],
                            cfg)
    assert BL == 200_064 and per_chrom == [203, 131, 157, 124, 180]
    N = 2 * sum(per_chrom) * cfg["max_candidates"]
    assert sum(per_chrom) == 795 and N == 12_720
    assert sharded.select_slots(N) == 32_768 > sharded.SELECT_SHARED_SLOTS


def _small_cell(seed):
    """An Arabidopsis-shaped deployment of SMALL_BP bases in TAIR10's
    length ratios, with the configuration's repeats, read profile (1.2 kb
    mean, so one band call a bucket stays cheap on the CPU) and similar
    genome, and the cell's traffic at blocks of SMALL_BLOCK."""
    cfg = copy.deepcopy(CONFIG)
    total = sum(TAIR10.values())
    cfg["genome"]["chromosomes"] = [[c, n * SMALL_BP // total]
                                    for c, n in TAIR10.items()]
    cfg["reads"]["mean_len"] = 1200
    traffic = copy.deepcopy(TRAFFIC)
    traffic["aligner"]["block_size"] = SMALL_BLOCK
    return deployment.build(cfg, seed, 2.0, {"similar", "reads"}), traffic


def test_mesh_path_equals_reference_at_athal_shape():
    torch.set_num_threads(1)
    dep, traffic = _small_cell(2147483700)
    reads, target = dep["reads"], dep["similar"]
    cfg = traffic["aligner"]
    BL, per_chrom = _blocks(target.lengths, cfg)
    NB = sum(per_chrom)
    assert NB >= 513 and 2 * NB * cfg["max_candidates"] > 8192
    ref = Reference(target, cfg, "mesh")
    # reads of one bucket (up to 2,048 bases): three inside repeat copies
    # (four candidates or more: the read's copies) and three that are not
    repeat, single = [], []
    for r in range(len(reads)):
        if not 512 < reads.size(r) <= 2048:
            continue
        n = len(ref._lanes_mesh(r, reads.get(r)))
        (repeat if n >= 4 else single if n == 1 else []).append(r)
        if len(repeat) >= 3 and len(single) >= 3:
            break
    assert len(repeat) >= 3 and len(single) >= 3
    rids = sorted(repeat[:3] + single[:3])
    want = ref.align(reads, rids)
    job = Job(dep, traffic, [torch.device("cpu")])
    got = job.texts(job.run(rids), {reads.names[r] for r in rids})
    assert job.aligner._block_index.sorted_codes.shape[0] == NB
    assert sum(map(bool, want.values())) >= 4
    for r in rids:
        assert got.get(reads.names[r], []) == want[r], r


# ---------------------------------------------------------------------------
# the seed step at the deployment's real size, on a card

CARD_READS = 25        # the mesh path's rows for reads of the 10,240 bucket
CARD_NQ = 10240
UNIT, COPIES = 3000, 1000


def _athal_target(rng):
    """TAIR10's five chromosomes of random bases, with COPIES 2%-diverged
    copies of one UNIT-bp repeat pasted over them (about 1.3 a block, as
    the deployment's repeat families), and the unit."""
    chroms = [synth.random_codes(rng, n) for n in TAIR10.values()]
    unit = synth.random_codes(rng, UNIT)
    for _ in range(COPIES):
        c = chroms[int(rng.integers(0, len(chroms)))]
        at = int(rng.integers(0, len(c) - 2 * UNIT))
        copy_ = synth.mutate(rng, unit, sub=0.02, ins=0.005, dele=0.005)
        c[at:at + len(copy_)] = copy_
    return chroms, unit


def _card_reads(rng, chroms, unit):
    """CARD_READS reads of 9 kb at the deployment's error profile: a third
    from the repeat unit with its flanks, the rest from anywhere, either
    strand; padded to CARD_NQ."""
    q_fwd = np.zeros((CARD_READS, CARD_NQ), np.uint8)
    q_rev = np.zeros_like(q_fwd)
    lens = np.zeros(CARD_READS, np.int32)
    for r in range(CARD_READS):
        if r % 3 == 0:
            seg = np.concatenate([synth.random_codes(rng, 3000), unit,
                                  synth.random_codes(rng, 3000)])
        else:
            c = chroms[int(rng.integers(0, len(chroms)))]
            at = int(rng.integers(0, len(c) - 9000))
            seg = c[at:at + 9000]
        if rng.random() < 0.5:
            seg = synth.revcomp(seg)
        read = synth.mutate(rng, seg, sub=0.13 / 6, ins=0.13 / 2,
                            dele=0.13 / 3)[:CARD_NQ]
        q_fwd[r, :len(read)] = read
        q_rev[r, :len(read)] = synth.revcomp(read)
        lens[r] = len(read)
    return q_fwd, q_rev, lens


@pytest.mark.card
def test_card_seed_step_at_athal_size(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = TRAFFIC["aligner"]
    rng = np.random.default_rng([2147483700, 19])
    chroms, unit = _athal_target(rng)
    db = SeqDatabase.from_arrays(
        np.concatenate(chroms),
        np.concatenate([[0], np.cumsum([len(c) for c in chroms])]),
        list(TAIR10))
    BL = sharded.mesh_block_len(int(db.lengths.max()), cfg["block_size"],
                                cfg["band_width"])
    index = sharded.build_block_index(db, cfg["seed_k"], BL)
    K = cfg["max_candidates"]
    NB = len(index.block_lens)
    assert NB == 795 and 2 * NB * K == 12_720
    mesh = make_mesh(devices=[torch.device("cuda", 0)], block_parallel=1)
    dev_index = sharded.put_sharded_index(index, mesh)
    seeder = sharded.make_sharded_seeder(
        mesh, k=cfg["seed_k"], BL=BL, bin_w=max(cfg["band_width"] // 2, 32),
        min_hits=cfg["min_block_hits"], alpha=cfg["alpha"], beta=cfg["beta"],
        K=K, prune=cfg["delta"] ** 2)
    reads = _card_reads(rng, chroms, unit)
    launches = (sharded.seed_block.launches,
                sharded.select_candidates.launches)
    monkeypatch.setattr(timing, "_counts", {})
    timing.tracing()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        got = seeder(*reads, *dev_index)
    c = timing.counts()
    assert sharded.seed_block.launches > launches[0]
    assert sharded.select_candidates.launches == launches[1] + 1
    assert c["seed.read_blocks"] == 2 * CARD_READS * NB
    assert c["select.candidates"] == CARD_READS * 12_720
    assert c["select.scratch_rows"] == CARD_READS
    assert c["seed.selected"] == int(got[0].sum())
    # the repeat's reads fill their K slots from the copies
    assert got[0][::3].sum(1).min() == K
    # the same step through the plain versions, on the same card
    monkeypatch.setattr(sharded, "_seed_reads",
                        lambda q_f, q_r, ln, sc, sp, sdir, **kw:
                        sharded._seed_reads_ref(q_f, q_r, ln, sc, sp, **kw))
    monkeypatch.setattr(sharded, "_select_read_candidates",
                        sharded._select_read_candidates_ref)
    want = seeder(*reads, *dev_index)
    for name, w, g in zip(("sel", "block", "strand", "diag", "cnt",
                           "score"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
