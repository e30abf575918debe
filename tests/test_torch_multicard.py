"""Which cards a process of the port owns (aligngraph2_tpu_torch/parallel/
distributed.py::local_cards), and the mesh the pipeline builds over them,
on the CPU with the card count and the process group faked:

  * card i belongs to the process whose local rank is i % (processes on
    the host), from torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE, else from
    the rank and the world size; with no group every card is the
    process's own (the JAX package's ``jax.local_devices()``);
  * init_distributed refuses a host with more processes than cards
    before it joins a group, naming both counts, and otherwise takes the
    process's first card as its current one;
  * ``make_mesh()`` and ``pipeline/driver.py::_make_mesh`` hold only
    the owned cards, and the mesh is on by default only for a process
    that owns more than one (``jax.local_device_count() > 1``).

No card, no process group and no CUDA call: ``torch.cuda.is_available``
and ``device_count`` are replaced for each test, and so are the group's
size and rank where a test puts the process in one."""

import pytest
import torch

from aligngraph2_tpu_torch.config import PipelineConfig
from aligngraph2_tpu_torch.parallel import distributed
from aligngraph2_tpu_torch.parallel.mesh import make_mesh
from aligngraph2_tpu_torch.pipeline.driver import _make_mesh

torch.set_num_threads(1)


@pytest.fixture
def host(monkeypatch):
    """host(cards, world=1, rank=0, local=None): fake ``cards`` CUDA
    cards and, with world > 1, a process group of ``world`` processes in
    which this one has ``rank``; ``local`` = (LOCAL_RANK,
    LOCAL_WORLD_SIZE) as torchrun sets them, None for neither."""
    def make(cards, world=1, rank=0, local=None):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        monkeypatch.setattr(distributed, "process_count", lambda: world)
        monkeypatch.setattr(distributed, "process_index", lambda: rank)
        for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        if local is not None:
            monkeypatch.setenv("LOCAL_RANK", str(local[0]))
            monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local[1]))
    return make


@pytest.mark.parametrize("local_world, cards, owned", [
    (4, 4, [[0], [1], [2], [3]]),
    (2, 4, [[0, 2], [1, 3]]),
    (4, 8, [[0, 4], [1, 5], [2, 6], [3, 7]]),
    (1, 4, [[0, 1, 2, 3]]),
])
def test_local_cards_by_local_rank(host, local_world, cards, owned):
    """A two-host group of 2 x local_world processes: each process owns
    the cards i with i % local_world == its local rank, so the host's
    processes share out its cards and no card has two owners."""
    for local_rank in range(local_world):
        host(cards, world=2 * local_world, rank=local_world + local_rank,
             local=(local_rank, local_world))
        assert distributed.local_cards() == owned[local_rank]
    assert sorted(sum(owned, [])) == list(range(cards))


@pytest.mark.parametrize("world, cards", [(4, 4), (2, 4), (4, 8)])
def test_local_cards_without_torchrun_env_take_rank_and_world(host, world,
                                                              cards):
    """Without LOCAL_RANK / LOCAL_WORLD_SIZE every process is on one host:
    the rank and the world size stand for them."""
    for rank in range(world):
        host(cards, world=world, rank=rank)
        assert distributed.local_cards() == list(range(rank, cards, world))


@pytest.mark.parametrize("cards", [0, 1, 4])
def test_local_cards_without_group_are_every_card(host, cards):
    host(cards)
    assert distributed.local_cards() == list(range(cards))
    host(cards, local=(1, 4))   # torchrun's variables alone change nothing
    assert distributed.local_cards() == list(range(cards))


def _no_group(monkeypatch):
    """Fail the test if init_distributed joins a group or sets a card."""
    def refuse(*a, **kw):
        raise AssertionError("must not be reached")
    monkeypatch.setattr(distributed.dist, "init_process_group", refuse)
    monkeypatch.setattr(torch.cuda, "set_device", refuse)


@pytest.mark.parametrize("local", [None, (5, 8)])
def test_init_distributed_refuses_more_processes_than_cards(host,
                                                            monkeypatch,
                                                            local):
    host(4, local=local)
    _no_group(monkeypatch)
    with pytest.raises(ValueError, match="8 processes on this host but 4 "
                                         "CUDA cards"):
        distributed.init_distributed("tcp://localhost:1", world_size=8,
                                     rank=5)
    assert not distributed.dist.is_initialized()


@pytest.mark.parametrize("world, rank, local, card", [
    (4, 2, None, 2), (2, 1, None, 1), (8, 6, (2, 4), 2), (4, 3, (1, 2), 1)])
def test_init_distributed_takes_the_first_owned_card(host, monkeypatch,
                                                     world, rank, local,
                                                     card):
    host(4, local=local)
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    monkeypatch.setattr(
        distributed.dist, "init_process_group",
        lambda backend, **kw: calls.append((backend, kw["world_size"],
                                            kw["rank"])))
    assert distributed.init_distributed("tcp://localhost:1",
                                        world_size=world, rank=rank) == rank
    assert calls == [card, ("cpu:gloo,cuda:nccl", world, rank)]


def _cfg(sharded=None, device="cuda"):
    cfg = PipelineConfig()
    cfg.runtime.device = device
    cfg.runtime.sharded_align = sharded
    return cfg


def _cards(mesh):
    return [[d.index for d in row] for row in mesh.devices]


def test_one_owned_card_takes_the_single_device_path(host):
    for world, rank in ((4, 3), (1, 0)):
        host(4 if world > 1 else 1, world=world, rank=rank)
        assert _make_mesh(_cfg()) is None
        # asked for, the mesh is the one card
        mesh = _make_mesh(_cfg(sharded=True))
        assert mesh.shape == {"data": 1, "block": 1}
        assert _cards(mesh) == [[rank]]


@pytest.mark.parametrize("world, rank, local, cards, want", [
    (2, 1, None, 4, [[1], [3]]),
    (4, 0, (0, 2), 4, [[0], [2]]),
    (2, 0, None, 8, [[0, 2], [4, 6]]),
    (1, 0, None, 2, [[0], [1]]),
    (1, 0, None, 4, [[0, 1], [2, 3]]),
])
def test_mesh_holds_only_the_owned_cards(host, world, rank, local, cards,
                                         want):
    """Two or more owned cards turn the mesh on by default, over those
    cards only: 2x1 for two (block axis 1 below four devices), 2x2 for
    four."""
    host(cards, world=world, rank=rank, local=local)
    mesh = _make_mesh(_cfg())
    assert _cards(mesh) == want
    assert _cards(make_mesh()) == want
    assert all(d.type == "cuda" for d in mesh.devices.flat)
    assert _make_mesh(_cfg(sharded=False)) is None


def test_cpu_runs_take_no_card(host):
    """On the CPU the mesh is off unless asked for, and then it is the
    one CPU device, whatever cards the host has."""
    host(4)
    assert _make_mesh(_cfg(device="cpu")) is None
    mesh = _make_mesh(_cfg(sharded=True, device="cpu"))
    assert [d.type for d in mesh.devices.flat] == ["cpu"]


def test_make_mesh_without_a_card_raises(host):
    host(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
