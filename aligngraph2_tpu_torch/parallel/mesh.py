"""Device mesh construction.

Counterpart of ``aligngraph2_tpu/parallel/mesh.py``.  The mesh is a 2-D
grid of torch devices with two named axes:

  * ``data``  — reads are data-parallel across this axis (the analogue of
    the reference's thread-striped read loops, Aligner.tcc:28-29);
  * ``block`` — the similar-genome seeding index is sharded by genome
    block across this axis (the analogue of mecat2ref+'s genome block
    decomposition, README.md:43-51); the candidate tables of one data
    row's block shards are concatenated in block order.

Where ``jax.sharding.Mesh`` hands placement to XLA, here
``parallel/sharded.py`` runs each shard on its device itself.  A list of
CPU devices (``[torch.device("cpu")] * n``) makes a mesh of n shards on
the CPU, which runs every split and gather of the sharded path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, block) grid of devices."""

    devices: np.ndarray         # (data, block) object array of torch.device
    axis_names: tuple           # (data axis, block axis)

    @property
    def shape(self) -> dict:
        """{axis name: size}, data axis first."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_mesh(n_devices: int | None = None, block_parallel: int | None = None,
              data_axis: str = "data", block_axis: str = "block",
              devices=None) -> Mesh:
    """Build a (data, block) mesh over the local CUDA cards.

    ``block_parallel`` defaults to 2 when at least 4 devices are present,
    else 1 (all devices data-parallel).  ``devices`` overrides the device
    list; ``n_devices`` keeps its first n.  Raises when there is no
    device, or when ``block_parallel`` does not divide the count."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if not n:
        raise RuntimeError("no CUDA device for the mesh; pass devices=, "
                           "e.g. [torch.device('cpu')] * n")
    if block_parallel is None:
        block_parallel = 2 if n >= 4 else 1
    if n % block_parallel != 0:
        raise ValueError(f"{n} devices not divisible by "
                         f"block_parallel={block_parallel}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(n // block_parallel, block_parallel),
                (data_axis, block_axis))
