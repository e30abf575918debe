"""The port's traversal and per-group assembly (aligngraph2_tpu_torch/
traverse/) on the CPU against the JAX package's, on one group of the
legacy 6 kb pipeline dataset (tests/_torch_group.py): assemble_group's
consumed contigs, connections and files must be equal, exactly, with the
native travel core and with the Python travel."""

import os

import pytest
import torch

from tests import _torch_group as tg

torch.set_num_threads(1)


def _assemble(pkg, out_dir):
    walk = tg.module(pkg, "traverse.walk")
    assembly = tg.module(pkg, "traverse.assembly")
    graph, pp, inp = tg.build_graph(pkg)
    eps = 10   # GraphConfig's default epsilon, as the driver passes it
    st = walk.TravelState(
        graph=graph, ctgs=inp["ctgs"], refs=inp["refs"],
        ctg_mapper=pp.ctg_mapper, ref_mapper=pp.ref_mapper,
        deviation=eps * 2, error_rate=0.15, start_split=0.90, min_len=50,
        top_k=8, threads=2)
    return assembly.assemble_group(st, inp["group"].contigs, out_dir, "0_")


@pytest.fixture(scope="module")
def jax_result(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_group"))
    return _assemble("jax", out), out


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("native", [True, False],
                         ids=["native_travel", "python_travel"])
def test_assemble_group_equals_jax(jax_result, tmp_path, monkeypatch,
                                   native):
    if native:
        from aligngraph2_tpu_torch.traverse.native import get_lib
        assert get_lib() is not None, "native/traverse.cpp did not build"
    else:
        monkeypatch.setenv("ALIGNGRAPH2_TPU_TORCH_NO_NATIVE", "1")
    want, want_dir = jax_result
    got = _assemble("torch", str(tmp_path))
    assert want.connections, "the group formed no chain"
    assert got.success == want.success
    assert got.connections == want.connections
    assert _files(str(tmp_path)) == _files(want_dir)
