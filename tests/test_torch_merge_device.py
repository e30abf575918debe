"""The port's device graph merge (aligngraph2_tpu_torch/graph/
merge_device.py) on ``device="cpu"`` against the JAX package's
``merge_device`` on the CPU and against the numpy specification (the port's
PAGraph with ALIGNGRAPH2_TPU_TORCH_MERGE=numpy), on the cases of
tests/test_merge_device.py plus inputs past int32 / uint32, where the JAX
version returns None and the port must still equal the spec.  Tolerance:
exact equality."""

import numpy as np
import pytest
import torch

from aligngraph2_tpu_torch.graph.merge_device import (merge_edges_device,
                                                      merge_positions_device)
from aligngraph2_tpu_torch.graph.pagraph import PAGraph

torch.set_num_threads(1)

POS = ("pos_node", "pos_ctg", "pos_ref", "pos_count")
EDGE = ("edge_from", "edge_to", "edge_step")


def _rand_positions(rng, n, n_nodes, zero_frac=0.2, cluster_frac=0.5):
    """tests/test_merge_device.py's generator: many near-duplicates and 0
    coordinates."""
    node = rng.integers(0, n_nodes, n)
    base_c = rng.integers(0, 5000, n)
    base_r = rng.integers(0, 5000, n)
    dup = rng.random(n) < cluster_frac
    base_c[dup] = (base_c[dup] // 700) * 700 + rng.integers(0, 12, dup.sum())
    base_r[dup] = (base_r[dup] // 700) * 700 + rng.integers(0, 12, dup.sum())
    base_c[rng.random(n) < zero_frac] = 0
    base_r[rng.random(n) < zero_frac] = 0
    return node, base_c, base_r


def _merge_pos(monkeypatch, backend, codes, k, pos, epsilon):
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", backend)
    g = PAGraph(codes, k, device="cpu")
    g.append_positions(*pos)
    removed = g.merge_positions(epsilon)
    return removed, [getattr(g, f).copy() for f in POS]


def _jax_pos(g_pos, epsilon):
    """The JAX package's device merge on the graph's stored arrays."""
    from aligngraph2_tpu.graph.merge_device import merge_positions_device as j
    node, ctg, ref = g_pos
    return j(node, ctg, ref, np.ones(len(node), np.uint16), epsilon)


def _stored(codes, k, pos):
    """The position streams as PAGraph stores them (int32/uint32)."""
    g = PAGraph(codes, k, device="cpu")
    g.append_positions(*pos)
    g._flush()
    return g.pos_node, g.pos_ctg, g.pos_ref


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(i))


def test_device_path_actually_runs():
    res = merge_positions_device(np.array([1, 1], np.int64),
                                 np.array([5, 6], np.uint64),
                                 np.array([5, 6], np.uint64),
                                 np.array([1, 1], np.int64), 10, "cpu")
    assert len(res[0]) == 1 and int(res[3][0]) == 2
    res = merge_edges_device(np.array([1, 1], np.int64),
                             np.array([2, 2], np.int64),
                             np.array([3, 3], np.int64), 16, "cpu")
    assert len(res[0]) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("epsilon", [0, 10])
def test_merge_positions_equal_spec_and_jax(monkeypatch, seed, epsilon):
    rng = np.random.default_rng(seed)
    k, n_nodes = 5, 64
    codes = rng.choice(4 ** k, size=n_nodes, replace=False)
    pos = _rand_positions(rng, 5000, n_nodes)
    rm_spec, spec = _merge_pos(monkeypatch, "numpy", codes, k, pos, epsilon)
    rm_dev, dev = _merge_pos(monkeypatch, "device", codes, k, pos, epsilon)
    assert rm_spec == rm_dev and rm_dev > 0
    _assert_all_equal(dev, spec)
    _assert_all_equal(dev, _jax_pos(_stored(codes, k, pos), epsilon))
    assert [a.dtype for a in dev] == [np.int32, np.uint32, np.uint32,
                                      np.uint16]


def test_merge_positions_saturation(monkeypatch):
    """uint16 CountType saturation must match the spec."""
    codes, k, n = np.arange(16), 4, 80000
    pos = (np.zeros(n, np.int64), np.full(n, 100, np.int64),
           np.full(n, 200, np.int64))
    _, spec = _merge_pos(monkeypatch, "numpy", codes, k, pos, 10)
    _, dev = _merge_pos(monkeypatch, "device", codes, k, pos, 10)
    _assert_all_equal(dev, spec)
    _assert_all_equal(dev, _jax_pos(_stored(codes, k, pos), 10))
    assert dev[3][0] == 0xFFFF


def test_merge_positions_uint32_wrap_values(monkeypatch):
    """Coordinates near the uint32 ceiling: 1 and 2^32 - 6 are far apart,
    though a wrapping distance would merge them."""
    hi = 0xFFFFFFFF
    codes, k = np.arange(16), 4
    pos = (np.array([3, 3, 3, 3, 3], np.int64),
           np.array([hi, hi - 5, 1, 0, hi - 3], np.int64),
           np.array([hi, hi - 5, 1, 0, hi - 2], np.int64))
    _, spec = _merge_pos(monkeypatch, "numpy", codes, k, pos, 10)
    _, dev = _merge_pos(monkeypatch, "device", codes, k, pos, 10)
    _assert_all_equal(dev, spec)
    _assert_all_equal(dev, _jax_pos(_stored(codes, k, pos), 10))
    assert len(dev[0]) == 3   # {0}, {1}, {2^32 - 6 .. 2^32 - 1}


@pytest.mark.parametrize("seed", [0, 3])
def test_merge_edges_equal_spec_and_jax(monkeypatch, seed):
    from aligngraph2_tpu.graph.merge_device import merge_edges_device as j
    rng = np.random.default_rng(seed)
    k, n_nodes, n = 5, 64, 4000
    codes = rng.choice(4 ** k, size=n_nodes, replace=False)
    edges = (rng.integers(0, n_nodes, n), rng.integers(0, n_nodes, n),
             rng.integers(1, 8, n))
    outs = {}
    for backend in ("numpy", "device"):
        monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", backend)
        g = PAGraph(codes, k, device="cpu")
        g.append_edges(*edges)
        removed = g.merge_edges()
        outs[backend] = (removed, [getattr(g, f).copy() for f in EDGE])
    assert outs["numpy"][0] == outs["device"][0] > 0
    _assert_all_equal(outs["device"][1], outs["numpy"][1])
    _assert_all_equal(outs["device"][1],
                      j(*(e.astype(np.int32) for e in edges), n_nodes))


def test_finalize_after_device_merge(monkeypatch):
    """finalize()'s CSR offsets are equal whether built from the device
    merge's output (the sorted-flag fast path) or the spec's."""
    rng = np.random.default_rng(9)
    k, n_nodes = 5, 64
    codes = rng.choice(4 ** k, size=n_nodes, replace=False)
    pos = _rand_positions(rng, 3000, n_nodes)
    edges = (rng.integers(0, n_nodes, 500), rng.integers(0, n_nodes, 500),
             rng.integers(1, 6, 500))
    outs = []
    for backend in ("numpy", "device"):
        monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", backend)
        g = PAGraph(codes, k, device="cpu")
        g.append_positions(*pos)
        g.append_edges(*edges)
        g.merge_edges()
        g.merge_positions(10)
        g.finalize()
        outs.append(g)
    a, b = outs
    for name in ("pos_start", "edge_start", *POS, *EDGE):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_positions_past_uint32_equal_spec(monkeypatch):
    """Coordinates past 2^32 and node ids past int32: the JAX version
    returns None there; the port equals the numpy spec on the same
    int64 arrays."""
    from aligngraph2_tpu.graph.merge_device import merge_positions_device as j
    rng = np.random.default_rng(4)
    node, ctg, ref = _rand_positions(rng, 4000, 40)
    node = node.astype(np.int64) + (1 << 31) * (node % 2)
    ctg = ctg.astype(np.int64) + (1 << 32) * (rng.random(4000) < 0.5)
    ref = ref.astype(np.int64) * 3
    cnt = rng.integers(1, 3, 4000).astype(np.uint16)
    assert j(node, ctg, ref, cnt, 10) is None
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", "numpy")
    g = PAGraph(np.arange(16), 4, device="cpu")
    g.pos_node, g.pos_ctg, g.pos_ref, g.pos_count = node, ctg, ref, cnt
    removed = g.merge_positions(10)
    dev = merge_positions_device(node, ctg, ref, cnt, 10, "cpu")
    assert removed == len(node) - len(dev[0]) and removed > 0
    _assert_all_equal(dev, [getattr(g, f) for f in POS])
    assert dev[1].max() > 0xFFFFFFFF


def test_edges_past_int32_equal_spec():
    """Fields past int32 (and a negative step): the JAX version returns
    None there; the port equals numpy's row dedup, the spec's order."""
    from aligngraph2_tpu.graph.merge_device import merge_edges_device as j
    rng = np.random.default_rng(6)
    n = 3000
    edges = (rng.integers(0, 50, n) + (1 << 33),
             rng.integers(0, 50, n), rng.integers(-3, 5, n))
    assert j(*edges, 1 << 34) is None
    got = merge_edges_device(*edges, 1 << 34, "cpu")
    want = np.unique(np.stack(edges, axis=1), axis=0)
    assert len(want) < n
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[:, i])


@pytest.mark.parametrize("var", ["ALIGNGRAPH2_TPU_TORCH_MERGE",
                                 "ALIGNGRAPH2_TPU_TORCH_CONSENSUS"])
def test_switch_takes_device_and_refuses_unknown(monkeypatch, var):
    """Both switches default to ``auto``, which is ``native`` on the CPU,
    take ``device`` and raise on a value that names no backend."""
    from aligngraph2_tpu_torch.utils.backend import resolve_backend
    choices = ("native", "device", "numpy")
    monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("ALIGNGRAPH2_TPU_TORCH_LINK_MBPS", raising=False)
    assert resolve_backend(var, choices, "cpu") == "native"
    monkeypatch.setenv(var, "device")
    assert resolve_backend(var, choices) == "device"
    monkeypatch.setenv(var, "gpu")
    with pytest.raises(ValueError, match=var):
        resolve_backend(var, choices)
