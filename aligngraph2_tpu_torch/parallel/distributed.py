"""Multi-process runs: ``torch.distributed`` set-up and host-level data
sharding.

Counterpart of ``aligngraph2_tpu/parallel/distributed.py``, with
``torch.distributed`` in place of ``jax.distributed``:

  * every process calls :func:`init_distributed` once, with the
    rendezvous address, world size and rank as arguments, or from the
    ``WORLD_SIZE``/``RANK``/``MASTER_ADDR`` environment that ``torchrun``
    sets; the process group carries CPU tensors over gloo and, where a
    card is present, CUDA tensors over NCCL (``cpu:gloo,cuda:nccl``);
  * each process owns the cards :func:`local_cards` gives it (the JAX
    package's ``jax.local_devices()``): its device mesh and its current
    card are among them, and no two processes share a card;
  * input reads are sharded BY PROCESS with :func:`host_shard` — each
    process aligns only its slice of the reads;
  * per-process results are merged with the helpers below: byte blobs and
    alignments gathered over gloo, dense k-mer count tables summed by an
    ``all_reduce`` on the run's device (NCCL on cards).

A single-process run skips all of this: every helper is the identity
when no process group is initialised or the world has one process.
"""

from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> int:
    """Join the process group (idempotent); returns this process's rank.

    ``init_method`` is a ``tcp://host:port`` address; without arguments
    the ``torchrun`` environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) is read.  With neither, or with one
    process, nothing is initialised and the rank is 0.  Where CUDA is
    present each process owns the cards :func:`local_cards` names and
    takes the first of them as its current card, so NCCL sees one card
    per process; a host with more processes than cards raises
    ValueError before the group is joined (two ranks on one card would
    fail NCCL's first collective).  The group is destroyed when the
    process exits: left to the interpreter's teardown, gloo's threads can
    abort a process that has finished."""
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env \
            and "MASTER_ADDR" in env:
        world_size = int(env["WORLD_SIZE"])
        rank = int(env["RANK"])
        init_method = init_method or "env://"
    if world_size is None or world_size <= 1:
        return 0
    backend = "gloo"
    if torch.cuda.is_available():
        local_rank, local_world = _local_slot(rank, world_size)
        n_cards = torch.cuda.device_count()
        if local_world > n_cards:
            raise ValueError(
                f"{local_world} processes on this host but {n_cards} "
                f"CUDA cards: each process needs a card of its own")
        torch.cuda.set_device(local_rank)
        backend = "cpu:gloo,cuda:nccl"
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    atexit.register(_destroy)
    return rank


def _local_slot(rank: int, world_size: int) -> tuple:
    """(local rank, processes on this host): ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets them, else the rank and the
    world size (every process on one host)."""
    env = os.environ
    return (int(env.get("LOCAL_RANK", rank)),
            int(env.get("LOCAL_WORLD_SIZE", world_size)))


def local_cards() -> list:
    """The CUDA card indices this process owns (``jax.local_devices``):
    every card with no process group or one process; in a group, card i
    iff i % (processes on this host) == this process's local rank
    (:func:`_local_slot`).  Empty without CUDA."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if process_count() <= 1:
        return list(range(n))
    local_rank, local_world = _local_slot(process_index(), process_count())
    return [i for i in range(n) if i % local_world == local_rank]


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """The number of processes of the run (``jax.process_count``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def host_shard(n_items: int, process_id: Optional[int] = None,
               num_processes: Optional[int] = None) -> slice:
    """The contiguous slice of a length-n work list owned by this process.

    Processes get near-equal contiguous slices (the first ``n % p`` get
    one extra)."""
    p = num_processes if num_processes is not None else process_count()
    i = process_id if process_id is not None else process_index()
    if p <= 1:
        return slice(0, n_items)
    base, extra = divmod(n_items, p)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return slice(start, stop)


def host_shard_ids(n_items: int, process_id: Optional[int] = None,
                   num_processes: Optional[int] = None) -> np.ndarray:
    """host_shard as an index array (for fancy-indexed databases)."""
    s = host_shard(n_items, process_id, num_processes)
    return np.arange(s.start, s.stop, dtype=np.int64)


def gather_host_bytes(data: bytes) -> list:
    """All-gather one bytes blob per process -> every process's blob, in
    rank order.  One process: [data].  The sizes go first, then the blobs
    padded to the largest as uint8 CPU tensors (gloo)."""
    p = process_count()
    if p <= 1:
        return [data]
    n = torch.tensor([len(data)], dtype=torch.int64)
    sizes = [torch.zeros_like(n) for _ in range(p)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    m = max(max(sizes), 1)
    buf = torch.zeros(m, dtype=torch.uint8)
    if data:
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    out = [torch.zeros_like(buf) for _ in range(p)]
    dist.all_gather(out, buf)
    return [o[:s].numpy().tobytes() for o, s in zip(out, sizes)]


def gather_alignments(alns):
    """Merge per-process AlignmentSets (rank order, so the result is
    deterministic).  One process: identity.  The interchange is the
    3-line .ref text itself (align/records.py)."""
    if process_count() <= 1:
        return alns
    from ..align.records import AlignmentSet
    out = AlignmentSet()
    for blob in gather_host_bytes(alns.to_ref_text().encode()):
        for a in AlignmentSet.from_ref_text(blob.decode()):
            out.append(a)
    return out


def agreed(flag: bool) -> bool:
    """The coordinator's ``flag`` on every process (identity with one
    process): a decision every process must take alike, such as reusing
    a stage whose cache files the coordinator is about to rewrite."""
    if process_count() <= 1:
        return flag
    t = torch.tensor([int(bool(flag))])
    dist.broadcast(t, src=0)
    return bool(t.item())


def is_coordinator() -> bool:
    return process_index() == 0


def barrier(name: str) -> None:
    """Cross-process sync point (no-op with one process): files the
    coordinator wrote are visible before the others read them.  A sum of
    one CPU tensor over gloo, which returns only when every process has
    reached it; ``name`` labels the point for a reader of the code."""
    if process_count() <= 1:
        return
    dist.all_reduce(torch.zeros(1))


def merge_host_counts(local_codes: np.ndarray, local_counts: np.ndarray,
                      k: int, dense_max: int = 1 << 26, device="cpu"):
    """Merge per-process sparse k-mer counts into the global solid-set
    input.  One process: identity.

    Dense path (4^k <= dense_max): each process scatters its counts into
    a dense int32 table on ``device`` and an ``all_reduce`` sums the
    tables (NCCL on a card, gloo on the CPU).  Sparse path (the k = 14
    default is 1 GB dense): (codes, counts) blobs gathered with
    :func:`gather_host_bytes` and merged on every process."""
    if process_count() <= 1:
        return local_codes, local_counts
    size = 1 << (2 * k)
    if size <= dense_max:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        dense = torch.zeros(size, dtype=torch.int32, device=dev)
        dense.index_add_(0, torch.from_numpy(
            np.ascontiguousarray(local_codes, np.int64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(
                local_counts, np.int32)).to(dev))
        dist.all_reduce(dense)
        arr = dense.cpu().numpy()
        codes = np.flatnonzero(arr)
        return codes.astype(np.int64), arr[codes].astype(np.int64)
    blob = (np.int64(len(local_codes)).tobytes()
            + np.ascontiguousarray(local_codes, np.int64).tobytes()
            + np.ascontiguousarray(local_counts, np.int64).tobytes())
    from ..ops.kmer import _merge_counts
    codes = np.zeros(0, np.int64)
    counts = np.zeros(0, np.int64)
    for b in gather_host_bytes(blob):
        n = int(np.frombuffer(b[:8], np.int64)[0])
        c = np.frombuffer(b[8:8 + 8 * n], np.int64)
        m = np.frombuffer(b[8 + 8 * n:8 + 16 * n], np.int64)
        codes, counts = _merge_counts(codes, counts, c, m)
    return codes, counts
