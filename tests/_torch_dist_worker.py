"""One process of a multi-process run on the CPU over gloo
(tests/test_torch_distributed.py).  Imports no JAX.  Usage:

    python tests/_torch_dist_worker.py <rank> <nprocs> <port> helpers
    python tests/_torch_dist_worker.py <rank> <nprocs> <port> pipeline \\
        <data_dir> <out_dir> <sharded>

``helpers`` checks the collective helpers of
aligngraph2_tpu_torch/parallel/distributed.py against what each process
can compute alone, and exits nonzero on a difference.  ``pipeline`` runs
the port's pipeline with tests/_torch_pipe.py's small configuration:
every process makes the same call into the same ``out_dir``, whose
coordinator-only writes and barriers make the directory the same as a
one-process run's; ``sharded`` = 1 runs the aligner stages on the mesh
path."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def helpers(rank: int, nprocs: int) -> None:
    import numpy as np
    from aligngraph2_tpu_torch.align.records import Alignment, AlignmentSet
    from aligngraph2_tpu_torch.ops.kmer import _merge_counts
    from aligngraph2_tpu_torch.parallel import distributed as d

    assert d.process_count() == nprocs and d.process_index() == rank
    assert d.is_coordinator() == (rank == 0)
    blobs = [b"", b"hello\x00world", bytes(range(256)) * 3][:nprocs]
    assert d.gather_host_bytes(blobs[rank]) == blobs
    assert d.agreed(rank == 0) is True
    assert d.agreed(rank != 0) is False
    mine = AlignmentSet([Alignment(f"q{rank}", "t", rank % 2 == 0, 10 + rank,
                                   0, 5, 7, 3, 8, 20, "ACGTA", "ACG-A")])
    assert d.gather_alignments(mine).to_ref_text() == "".join(
        AlignmentSet([Alignment(f"q{r}", "t", r % 2 == 0, 10 + r, 0, 5, 7,
                                3, 8, 20, "ACGTA", "ACG-A")]).to_ref_text()
        for r in range(nprocs))
    # each process's counts of k = 6 codes; both merge paths equal the
    # counts merged in one process
    per = []
    for r in range(nprocs):
        rng = np.random.default_rng(r)
        codes = np.unique(rng.integers(0, 1 << 12, 300 + 50 * r))
        per.append((codes.astype(np.int64),
                    rng.integers(1, 9, len(codes)).astype(np.int64)))
    want = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    for codes, counts in per:
        want = _merge_counts(*want, codes, counts)
    for dense_max in (1 << 26, 1):     # dense all_reduce, sparse gather
        got = d.merge_host_counts(*per[rank], k=6, dense_max=dense_max)
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    d.barrier("helpers")


def pipeline(data_dir: str, out_dir: str, sharded: bool) -> None:
    from aligngraph2_tpu_torch.pipeline.driver import run_pipeline
    from tests._torch_pipe import small_cfg
    cfg = small_cfg("torch")
    cfg.runtime.sharded_align = sharded
    run_pipeline(*(os.path.join(data_dir, n)
                   for n in ("reads.fq", "ctg.fa", "genome.fa")),
                 out_dir, cfg, log=lambda *a: None)


def main() -> None:
    rank, nprocs, port, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    import torch
    torch.set_num_threads(1)
    from aligngraph2_tpu_torch.parallel.distributed import init_distributed
    init_distributed(f"tcp://localhost:{port}", world_size=nprocs, rank=rank,
                     timeout_s=600)
    if mode == "helpers":
        helpers(rank, nprocs)
    else:
        pipeline(sys.argv[5], sys.argv[6], sys.argv[7] == "1")
    print(f"rank {rank} done", flush=True)


if __name__ == "__main__":
    main()
