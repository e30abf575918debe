"""The port's stage 1 (aligngraph2_tpu_torch/ops/kmer.py) on the CPU against
the JAX package's, on the reads of the legacy 6 kb pipeline dataset: the
solid-k-mer set (native core and numpy spec), the solid-set file bytes,
the k-mer codes of a padded batch and the dense counter must be equal,
exactly."""

import numpy as np
import pytest
import torch

from aligngraph2_tpu.io.seqdb import SeqDatabase as JDB
from aligngraph2_tpu.ops import kmer as jk
from aligngraph2_tpu_torch.io.seqdb import SeqDatabase as TDB
from aligngraph2_tpu_torch.ops import kmer as tk
from tests import _torch_group as tg

torch.set_num_threads(1)

# (k, threshold): two regimes with a cutoff above 0, and the pipeline
# test's k=12 / 0.05, whose cutoff is 0 so that all 4^k codes are solid
CASES = [(6, 0.2), (8, 0.05), (12, 0.05)]


@pytest.fixture(scope="module")
def reads():
    return tg.dataset()["reads"]


@pytest.mark.parametrize("k,threshold", CASES)
def test_solid_set_equals_jax(reads, k, threshold):
    want = jk.solid_set(JDB(reads), k, threshold)
    db = TDB(reads)
    from aligngraph2_tpu_torch.ops.native import get_lib
    assert get_lib() is not None, "native/seedhits.cpp did not build"
    native = tk.solid_set(db, k, threshold)
    spec = tk.count_reads_sorted(db, k).solid_codes(threshold)
    sc = tk.count_reads_sorted(db, k)
    cutoff = tk.solid_min_abundance_sparse(sc.counts_arr, sc.table_size,
                                           threshold)
    assert (cutoff == 0) == (k == 12)
    if cutoff == 0:
        assert len(want) == 1 << (2 * k)
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(spec, want)


def test_solid_set_file_bytes_equal(reads, tmp_path):
    k, threshold = CASES[0]
    codes = tk.solid_set(TDB(reads), k, threshold)
    jk.write_solid_set(str(tmp_path / "jax.bin"), k,
                       jk.solid_set(JDB(reads), k, threshold))
    tk.write_solid_set(str(tmp_path / "torch.bin"), k, codes)
    assert (tmp_path / "jax.bin").read_bytes() == \
        (tmp_path / "torch.bin").read_bytes()
    k2, back = tk.read_solid_set(str(tmp_path / "jax.bin"))
    assert k2 == k
    np.testing.assert_array_equal(back, codes)


@pytest.mark.parametrize("k", [3, 11])
def test_kmer_codes_batch_equals_jax(reads, k):
    rng = np.random.default_rng(k)
    ids = rng.choice(len(reads), 12, replace=False)
    batch, lens = JDB(reads).padded_batch(ids, 2048)
    lens[3] = k - 1   # a row too short for one k-mer
    want_c, want_v = (np.asarray(x)
                      for x in jk.kmer_codes_batch(batch, lens, k))
    got_c, got_v = tk.kmer_codes_batch(torch.from_numpy(batch),
                                       torch.from_numpy(lens), k)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_c.numpy(), want_c)


@pytest.mark.parametrize("k", [5, 9])
def test_counter_equals_jax(reads, k):
    want = jk.count_reads(JDB(reads), k, batch_reads=16).counts()
    got = tk.count_reads(TDB(reads), k, batch_reads=16, device="cpu")
    assert got.table.dtype == torch.int32
    np.testing.assert_array_equal(got.counts(), want)
    assert int(got.counts().sum()) == sum(len(s) - k + 1 for _, s in reads)
    np.testing.assert_array_equal(got.solid_codes(0.2),
                                  jk.count_reads(JDB(reads), k,
                                                 batch_reads=16)
                                  .solid_codes(0.2))


def test_counter_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tk.KmerCounter(5)
