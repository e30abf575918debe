"""The port's graph ingest and merges (aligngraph2_tpu_torch/graph/) on the
CPU against the JAX package's, on one group of the legacy 6 kb pipeline
dataset (tests/_torch_group.py): the PAGraph arrays after
PositionProcessor.pre_process and process must be equal, exactly, with
the native ingest core and with the Python pass."""

import numpy as np
import pytest
import torch

from aligngraph2_tpu_torch.graph.pagraph import PAGraph
from tests import _torch_group as tg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_graph():
    graph, _, _ = tg.build_graph("jax")
    return tg.graph_arrays(graph)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native_ingest", "python_pass"])
def test_pagraph_arrays_equal_jax(jax_graph, use_native):
    from aligngraph2_tpu_torch.graph.ingest_native import get_lib
    assert get_lib() is not None, "native/ingest.cpp did not build"
    graph, pp, _ = tg.build_graph("torch", use_native=use_native)
    got = tg.graph_arrays(graph)
    assert len(got["pos_node"]) > 1000 and len(got["edge_from"]) > 1000
    for name in tg.GRAPH_ARRAYS:
        np.testing.assert_array_equal(got[name], jax_graph[name],
                                      err_msg=name)


def _random_streams(seed, n_nodes=300, n=20000):
    """Position and edge streams with many exact and epsilon-near
    duplicates, plus 0 coordinates (which only match 0)."""
    rng = np.random.default_rng(seed)
    node = rng.integers(0, n_nodes, n).astype(np.int32)
    ctg = rng.integers(0, 400, n).astype(np.uint32) * 7
    ref = rng.integers(0, 400, n).astype(np.uint32) * 5
    ctg[rng.random(n) < 0.1] = 0
    ref[rng.random(n) < 0.1] = 0
    efrom = rng.integers(0, n_nodes, n).astype(np.int32)
    eto = rng.integers(0, n_nodes, n).astype(np.int32)
    estep = rng.integers(1, 40, n).astype(np.int32)
    return (node, ctg, ref), (efrom, eto, estep)


def _merged(monkeypatch, backend, seed, epsilon=10):
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", backend)
    pos, edges = _random_streams(seed)
    g = PAGraph(np.arange(300, dtype=np.int64), 6)
    g.append_positions(*pos)
    g.append_edges(*edges)
    removed = (g.merge_edges(), g.merge_positions(epsilon))
    g.finalize()
    return removed, tg.graph_arrays(g)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_native_equals_numpy(monkeypatch, seed):
    removed_n, native = _merged(monkeypatch, "native", seed)
    removed_p, spec = _merged(monkeypatch, "numpy", seed)
    assert removed_n == removed_p and min(removed_n) > 0
    for name in tg.GRAPH_ARRAYS:
        np.testing.assert_array_equal(native[name], spec[name],
                                      err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_edge_dedup_equals_numpy(seed):
    """merge_edges takes the native dedup only past its 63-bit packed key
    (about 2^29 nodes), beyond a test's reach; the core itself against
    the numpy row dedup."""
    from aligngraph2_tpu_torch.graph.ingest_native import merge_edges_native
    _, edges = _random_streams(seed)
    got = merge_edges_native(*edges)
    want = np.unique(np.stack(edges, axis=1), axis=0)
    assert len(want) < len(edges[0])
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[:, i])


@pytest.mark.parametrize("merge", ["merge_edges", "merge_positions"])
def test_device_merge_raises(monkeypatch, merge):
    """``device`` is a merge backend now (on the graph's device, here the
    CPU) and equals the spec; a value that names no backend raises."""
    pos, edges = _random_streams(0, n=100)
    args = () if merge == "merge_edges" else (10,)
    got = {}
    for backend in ("device", "numpy"):
        monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", backend)
        g = PAGraph(np.arange(300, dtype=np.int64), 6, device="cpu")
        g.append_positions(*pos)
        g.append_edges(*edges)
        removed = getattr(g, merge)(*args)
        g.finalize()
        got[backend] = (removed, tg.graph_arrays(g))
    assert got["device"][0] == got["numpy"][0]
    for name in tg.GRAPH_ARRAYS:
        np.testing.assert_array_equal(got["device"][1][name],
                                      got["numpy"][1][name], err_msg=name)
    monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_MERGE", "gpu")
    with pytest.raises(ValueError, match="expected one of native, device"):
        getattr(g, merge)(*args)
