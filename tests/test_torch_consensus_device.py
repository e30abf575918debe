"""The port's device consensus aggregation (aligngraph2_tpu_torch/consensus/
device.py) on ``device="cpu"`` against the JAX package's on the CPU.

Three layers, on the seeds and cases of tests/test_consensus_device.py:
  1. ``aggregate_device``'s outputs against the JAX package's, array for
     array.  The JAX tables are padded to powers of two in windows and
     stride; the port keys its tables with the encoding's own count and
     stride, so the JAX tables are cut to that layout, and what the cut
     drops must be empty (weight 0, first touch int32's minimum);
  2. ``assemble_window_tables`` against ``extract_window_tables`` (the
     numpy spec of consensus/reduced.py);
  3. consensus strings against the sequential POA oracle, the JAX
     package's device path and the native host core.
Tolerance: exact equality."""

import os

import numpy as np
import pytest
import torch

from aligngraph2_tpu_torch.consensus import device as tdev
from aligngraph2_tpu_torch.consensus.reduced import extract_window_tables
from tests.test_consensus_reduced import _oracle, _rand_read_aln

torch.set_num_threads(1)

BASES = "ACGT"
INT32_MIN = -(1 << 31)
ENC_ARRAYS = ("ops", "col2seg", "seg_win", "seg_start", "seg_weight",
              "seg_off", "win_col_off", "win_exit")
PER_STRIDE = ("bb_wt", "bb_cov", "enter_w", "enter_ft", "exit_w", "exit_ft")


def _empty_value(name):
    return INT32_MIN if name.endswith("_ft") else 0


def _jax_in_port_layout(jagg, nw, stride):
    """The JAX package's padded tables cut to (nw, stride); asserts that
    the cut-off entries are empty."""
    gm = tdev.GAP_SLOTS - 1
    out = {}
    for name in PER_STRIDE + ("mid_w", "mid_ft", "ee_w", "ee_ft"):
        a = np.asarray(jagg[name])
        if name.startswith("ee"):
            full, keep = a, a[:nw]
            rest = a[nw:]
        else:
            shape = (jagg["nw"], jagg["stride"]) + (
                (gm,) if name.startswith("mid") else ())
            full = a.reshape(shape)
            keep = full[:nw, :stride]
            mask = np.ones(full.shape, bool)
            mask[:nw, :stride] = False
            rest = full[mask]
        assert (rest == _empty_value(name)).all(), name
        out[name] = keep.reshape(-1)
    return out


def _assert_agg_equal(enc, agg, jagg):
    """The port's aggregates of ``enc`` against the JAX package's of the
    same encoding."""
    assert (agg["nw"], agg["stride"]) == (enc.n_windows, enc.window_stride)
    if len(enc.ops):
        want = _jax_in_port_layout(jagg, agg["nw"], agg["stride"])
        for name, arr in want.items():
            np.testing.assert_array_equal(agg[name], arr, err_msg=name)
    np.testing.assert_array_equal(agg["long_cols"], jagg["long_cols"])
    assert agg["n_chain_groups"] == jagg["n_chain_groups"]
    assert set(agg["chain_groups"]) == set(jagg["chain_groups"])
    for name, arr in jagg["chain_groups"].items():
        np.testing.assert_array_equal(agg["chain_groups"][name], arr,
                                      err_msg=name)


def _assert_flat_equal(enc, agg, jenc, jagg, lens):
    """assemble_flat of the port's aggregates against the JAX package's
    assemble_flat of its own: the flat arrays of the native merge do not
    depend on the tables' padding, so they must be equal."""
    from aligngraph2_tpu.consensus.device import assemble_flat as jflat
    stride_out = max(lens) + 2
    got = tdev.assemble_flat(enc, agg, lens, stride_out)
    want = jflat(jenc, jagg, lens, stride_out)
    assert set(got) == set(want)
    for name, arr in want.items():
        if isinstance(arr, np.ndarray):
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
        else:
            assert got[name] == arr, name


def _encode_both(window_alns, lens):
    """The port's and the JAX package's numpy encoders on the same
    windows: equal streams."""
    from aligngraph2_tpu.consensus.device import encode_windows_np as jenc_fn
    enc = tdev.encode_windows_np(window_alns, lens)
    jenc = jenc_fn(window_alns, lens)
    for name in ENC_ARRAYS:
        np.testing.assert_array_equal(getattr(enc, name),
                                      getattr(jenc, name), err_msg=name)
    for name in tdev.CHAIN_FIELDS:
        np.testing.assert_array_equal(enc.chains[name], jenc.chains[name],
                                      err_msg=name)
    return enc, jenc


def _tables_equal(a, b):
    assert a.skeleton_len == b.skeleton_len
    np.testing.assert_array_equal(a.bb_weight, b.bb_weight)
    np.testing.assert_array_equal(a.bb_cov, b.bb_cov)
    assert dict(a.edges) == dict(b.edges)
    assert set(a.chains) == set(b.chains)
    for k in a.chains:
        assert list(a.chains[k]) == list(b.chains[k]), k


def _check_window(window_alns, skeletons):
    """Layers 1-3 on one batch of windows."""
    from aligngraph2_tpu.consensus.device import aggregate_device as jagg_fn
    from aligngraph2_tpu.consensus.device import (
        window_consensus_via_device as jwin)
    lens = [len(s) for s in skeletons]
    enc, jenc = _encode_both(window_alns, lens)
    agg = tdev.aggregate_device(enc, "cpu")
    jagg = jagg_fn(jenc)
    _assert_agg_equal(enc, agg, jagg)
    _assert_flat_equal(enc, agg, jenc, jagg, lens)
    tables = tdev.assemble_window_tables(enc, agg, lens)
    for t, alns, L in zip(tables, window_alns, lens):
        _tables_equal(t, extract_window_tables(L, alns))
    for mw in (0, 2):
        got = tdev.window_consensus_via_device(skeletons, window_alns, mw,
                                               device="cpu")
        assert got == [_oracle(sk, alns, mw)
                       for sk, alns in zip(skeletons, window_alns)]
        assert got == jwin(skeletons, window_alns, mw)
    return agg


@pytest.mark.parametrize("seed", range(6))
def test_device_tables_equal_jax(seed):
    rng = np.random.default_rng(seed)
    skeletons, window_alns = [], []
    for _ in range(int(rng.integers(1, 4))):
        L = int(rng.integers(4, 50))
        sk = "".join(BASES[i] for i in rng.integers(0, 4, L))
        alns = []
        for _ in range(int(rng.integers(0, 20))):
            alns.append(_rand_read_aln(
                rng, sk, float(rng.choice([0.1, 0.4, 0.7])), alns))
        skeletons.append(sk)
        window_alns.append(alns)
    _check_window(window_alns, skeletons)


@pytest.mark.parametrize("seed", range(4))
def test_device_consensus_equals_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    skeletons, window_alns = [], []
    for _ in range(2):
        L = int(rng.integers(10, 60))
        sk = "".join(BASES[i] for i in rng.integers(0, 4, L))
        alns = []
        for _ in range(int(rng.integers(3, 30))):
            alns.append(_rand_read_aln(
                rng, sk, float(rng.choice([0.1, 0.5])), alns))
        skeletons.append(sk)
        window_alns.append(alns)
    _check_window(window_alns, skeletons)


def test_device_long_gap_and_overflow_chains():
    """The long-gap host patch (>= GAP_SLOTS deletions between matches)
    and the overflow chain path (> MAX_PACK inserted bases, twice)."""
    rng = np.random.default_rng(5)
    L = 120
    sk = "".join(BASES[i] for i in rng.integers(0, 4, L))
    q1 = sk[0] + "-" * 40 + sk[41:80]
    t1 = sk[:80]
    ins = "".join(BASES[i] for i in rng.integers(0, 4, 70))
    q2 = sk[10] + ins + sk[11]
    t2 = sk[10] + "-" * 70 + sk[11]
    alns = [(1, q1, t1, 3), (11, q2, t2, 2), (11, q2, t2, 1)]
    agg = _check_window([alns], [sk])
    assert len(agg["long_cols"]) >= 1
    assert (agg["chain_groups"]["flags"] & tdev.FLAG_OVERFLOW).any()


def test_device_int32_wrap_chain():
    """A 16-base insert chain whose base at index 15 is T sets bit 31 of
    its packed word: the word is a negative int32, and two identical
    chains still group (the JAX test's int32-wrap witness)."""
    sk = "ACGTACGTACGTACGTACGT"
    ins = "ACGTACGTACGTACGT"
    q = sk[4] + ins + sk[5]
    t = sk[4] + "-" * 16 + sk[5]
    alns = [(5, q, t, 3), (5, q, t, 2)]
    enc = tdev.encode_windows_np([alns], [len(sk)])
    assert enc.chains["b0"].dtype == np.int32 and (enc.chains["b0"] < 0).any()
    agg = _check_window([alns], [sk])
    assert agg["n_chain_groups"] == 1
    assert int(agg["chain_groups"]["wsum"][0]) == 5


def test_chain_weight_sums_wrap_like_int32():
    """Chain weights whose running sum passes 2^31: the port's int64
    cumsum must leave each group's sum as JAX's wrapping int32 one does."""
    from aligngraph2_tpu.consensus.device import aggregate_device as jagg_fn
    enc = tdev.EncodedWindows(1, 8)
    n = 6
    chains = {f: np.zeros(n, np.int32) for f in tdev.CHAIN_FIELDS}
    chains["prev"][:] = [1, 1, 2, 2, 3, 3]
    chains["length"][:] = 1
    chains["w"][:] = [(1 << 30) + 7, 5, (1 << 30), (1 << 30) - 1, 9, 11]
    chains["creation"][:] = np.arange(n)
    enc.chains = chains
    agg = tdev.aggregate_device(enc, "cpu")
    jagg = jagg_fn(enc)
    _assert_agg_equal(enc, agg, jagg)
    for name, arr in jagg["chain_groups"].items():
        np.testing.assert_array_equal(agg["chain_groups"][name], arr,
                                      err_msg=name)
    assert list(agg["chain_groups"]["wsum"]) == [(1 << 30) + 12,
                                                 (1 << 31) - 1, 20]


def test_device_empty_and_deletion_only():
    sk = "ACGTACGT"
    for alns in ([],
                 [(1, "--------", "ACGTACGT", 2)],
                 [(1, "ACGTACGT", "ACGTACGT", 1), (1, "----", "ACGT", 4)]):
        _check_window([alns], [sk])


# ------------- native encoder / full device path -------------


def _mk_alignments(rng, backbone, n, err=0.15):
    """tests/test_consensus_device.py's generator, as the port's
    records."""
    from aligngraph2_tpu_torch.align.records import Alignment
    L = len(backbone)
    alns = []
    for _ in range(n):
        ln = int(rng.integers(50, max(60, L // 2)))
        rb = int(rng.integers(0, L - ln))
        t = backbone[rb:rb + ln]
        qs, ts = [], []
        for ch in t:
            r = rng.random()
            if r < err * 0.4:
                qs.append(BASES[rng.integers(0, 4)]); ts.append(ch)
            elif r < err * 0.7:
                qs.append("-"); ts.append(ch)
            elif r < err:
                qs.append(BASES[rng.integers(0, 4)]); ts.append("-")
                qs.append(ch); ts.append(ch)
            else:
                qs.append(ch); ts.append(ch)
        q = "".join(qs)
        alns.append(Alignment(
            query_name="r", ref_name="b", forward=True,
            score=ln - int(err * ln * rng.random()),
            qb=0, qe=sum(c != "-" for c in q), qsize=ln,
            rb=rb, re=rb + ln, rsize=L, qstr=q, tstr="".join(ts)))
    return alns


def test_native_encoder_matches_spec(rng):
    """The port's native encoder against its Python spec and against the
    JAX package's spec encoder."""
    from aligngraph2_tpu.consensus.device import _encode_spec as jspec
    from aligngraph2_tpu_torch.consensus.native import encode_windows_native
    backbone = "".join(BASES[i] for i in rng.integers(0, 4, 900))
    alns = _mk_alignments(rng, backbone, 60)
    window, top_k, alpha = 250, 20, 50
    enc_c = encode_windows_native(backbone, alns, window, top_k, alpha)
    assert enc_c is not None, "native/poacns.cpp did not build"
    nw = (len(backbone) + window - 1) // window
    lens = [min(window, len(backbone) - i * window) for i in range(nw)]
    enc_py = tdev._encode_spec(backbone, alns, window, top_k, alpha, lens)
    enc_j = jspec(backbone, alns, window, top_k, alpha, lens)
    for other in (enc_py, enc_j):
        assert enc_c.n_windows == other.n_windows
        assert enc_c.window_stride == other.window_stride
        for name in ENC_ARRAYS:
            np.testing.assert_array_equal(getattr(enc_c, name),
                                          getattr(other, name),
                                          err_msg=name)
        for name in tdev.CHAIN_FIELDS:
            np.testing.assert_array_equal(enc_c.chains[name],
                                          other.chains[name], err_msg=name)


def _consensus(backbone, alns, cfg, backend, threads=2, **env):
    from aligngraph2_tpu_torch.consensus.window import consensus_backbone
    old = dict(os.environ)
    os.environ["ALIGNGRAPH2_TPU_TORCH_CONSENSUS"] = backend
    os.environ.update(env)
    try:
        return consensus_backbone(backbone, alns, cfg, threads=threads,
                                  device="cpu")
    finally:
        os.environ.clear()
        os.environ.update(old)


@pytest.fixture(scope="module")
def backbone_case():
    """A 1,500 bp backbone and 120 noisy alignments, with the consensus
    config of tests/test_consensus_device.py."""
    from aligngraph2_tpu_torch.align.records import AlignmentSet
    from aligngraph2_tpu_torch.config import ConsensusConfig
    rng = np.random.default_rng(0)
    backbone = "".join(BASES[i] for i in rng.integers(0, 4, 1500))
    alns = AlignmentSet(_mk_alignments(rng, backbone, 120))
    return backbone, alns, ConsensusConfig(window=400, top_k=40, alpha=60)


def test_full_device_path_matches_host_core(backbone_case):
    """consensus_backbone with ``device`` == the host C++ core == the
    Python spec == the JAX package's device path, on a multi-window
    backbone; with ALIGNGRAPH2_TPU_TORCH_NO_NATIVE=1 the device path's
    spec encoder and merge give the same string."""
    from aligngraph2_tpu.align.records import AlignmentSet as JSet
    from aligngraph2_tpu.config import ConsensusConfig as JConfig
    from aligngraph2_tpu.consensus.window import consensus_backbone as jcb
    backbone, alns, cfg = backbone_case
    outs = {b: _consensus(backbone, alns, cfg, b)
            for b in ("native", "device", "spec")}
    outs["device_no_native"] = _consensus(
        backbone, alns, cfg, "device", ALIGNGRAPH2_TPU_TORCH_NO_NATIVE="1")
    os.environ["ALIGNGRAPH2_TPU_CONSENSUS"] = "device"
    try:
        outs["jax_device"] = jcb(
            backbone, JSet.from_ref_text(alns.to_ref_text()),
            JConfig(window=400, top_k=40, alpha=60), threads=2)
    finally:
        del os.environ["ALIGNGRAPH2_TPU_CONSENSUS"]
    assert outs["native"] != backbone
    assert all(v == outs["native"] for v in outs.values()), outs.keys()


def test_assemble_flat_equals_jax(backbone_case):
    """The native encoding of a multi-window backbone: the port's
    aggregates and flat arrays against the JAX package's, with chains
    that hold interior deletions (patched at once in the port)."""
    from aligngraph2_tpu.consensus.device import aggregate_device as jagg_fn
    from aligngraph2_tpu_torch.consensus.native import encode_windows_native
    backbone, alns, cfg = backbone_case
    enc = encode_windows_native(backbone, list(alns), cfg.window, cfg.top_k,
                                cfg.alpha)
    assert enc is not None, "native/poacns.cpp did not build"
    nw = enc.n_windows
    lens = [min(cfg.window, len(backbone) - i * cfg.window)
            for i in range(nw)]
    agg = tdev.aggregate_device(enc, "cpu")
    jagg = jagg_fn(enc)
    _assert_agg_equal(enc, agg, jagg)
    flags = agg["chain_groups"]["flags"]
    assert (flags == tdev.FLAG_INTERIOR_DELS).sum() > 10
    _assert_flat_equal(enc, agg, enc, jagg, lens)


def test_reduced_consensus_native_on_tables(backbone_case):
    """The native reduced merge fed per-window WindowTables (built from
    the device aggregates) gives the host core's string."""
    from aligngraph2_tpu_torch.consensus.native import (
        encode_windows_native, reduced_consensus_native)
    backbone, alns, cfg = backbone_case
    enc = encode_windows_native(backbone, list(alns), cfg.window, cfg.top_k,
                                cfg.alpha)
    lens = [min(cfg.window, len(backbone) - i * cfg.window)
            for i in range(enc.n_windows)]
    tables = tdev.assemble_window_tables(
        enc, tdev.aggregate_device(enc, "cpu"), lens)
    got = reduced_consensus_native(backbone, cfg.window, tables,
                                   cfg.min_weight, 2)
    assert got == _consensus(backbone, alns, cfg, "native")


def test_device_path_in_batches_matches_host_core(backbone_case,
                                                  monkeypatch):
    """A column cap of a few hundred splits the backbone into batches
    (_slice_enc, _concat_flats): the string is unchanged."""
    backbone, alns, cfg = backbone_case
    want = _consensus(backbone, alns, cfg, "native")
    monkeypatch.setattr(tdev, "MAX_BATCH_COLS", 300)
    assert _consensus(backbone, alns, cfg, "device") == want
