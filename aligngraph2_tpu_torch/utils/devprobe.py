"""One-shot host<->device link probe, and the ``auto`` value of the two
backend switches.

Counterpart of ``aligngraph2_tpu/utils/devprobe.py``.  The device graph
merge and the device consensus equal the host C++ cores bit for bit, so
which one runs is a question of speed alone.  ``auto`` (the default of
both switches, ``utils/backend.py``) answers it once per process:

  * the probe copies 16 MB (2^20-byte MB) to the card and back,
    synchronising around each copy, and keeps the slower direction's
    MB/s (:func:`link_bandwidth_mbps`); it is 0.0 when the run's device
    is the CPU or no card is present;
  * ``ALIGNGRAPH2_TPU_TORCH_MERGE=auto`` is ``device`` when that rate
    clears ``DEVICE_MIN_MBPS``, else ``native``.  On an H100 the device
    merges took 94-410 ms per call against the native core's 2.2-7.6 s
    at 23-46 M rows, 65-92% of it copies of about 27 bytes a row
    (``PERF.md`` §6, ``chip_smoke.py``'s ``device_paths`` line).  The
    native core's time would be matched at about 290 MB/s of link;
    500 MB/s leaves a margin on both sides, as the JAX package's rule
    does;
  * ``ALIGNGRAPH2_TPU_TORCH_CONSENSUS=auto`` is ``native`` at any link
    rate: on the same card the device consensus took 14.7-16.4 s
    against the native core's 6.3-7.0 s, because its host assembly
    (the C++ encoder, the slice encoding, the Python assembly and the
    C++ reduced merge) outweighs the whole native call, while the card
    does 0.8 s of work and 0.3 s of copies.

An explicit value of either switch wins over ``auto``.
``ALIGNGRAPH2_TPU_TORCH_LINK_MBPS`` pins the measured rate (a user's pin,
and the tests' way to fake a link).
"""

from __future__ import annotations

import logging
import os
import time

import torch

logger = logging.getLogger("aligngraph2_tpu_torch.devprobe")

MERGE_VAR = "ALIGNGRAPH2_TPU_TORCH_MERGE"
CONSENSUS_VAR = "ALIGNGRAPH2_TPU_TORCH_CONSENSUS"
LINK_VAR = "ALIGNGRAPH2_TPU_TORCH_LINK_MBPS"

DEVICE_MIN_MBPS = 500.0

_PROBE_BYTES = 16 << 20
_cached_mbps: dict = {}     # card index -> measured MB/s, per process


def _card(device) -> torch.device | None:
    """The CUDA device ``device`` names (``cuda`` is the current card), or
    None for the CPU or when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def measure_link(device="cuda") -> dict:
    """One timed 16 MB copy each way between pageable host memory and
    ``device``, after a warm-up copy: {"up": MB/s, "down": MB/s}.
    Raises when ``device`` is not a usable card."""
    dev = _card(device)
    if dev is None:
        raise RuntimeError(f"no CUDA device to probe at {device!r}")
    host = torch.zeros(_PROBE_BYTES, dtype=torch.uint8)
    host.to(dev).cpu()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    on_card = host.to(dev)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    on_card.cpu()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    mb = _PROBE_BYTES / float(1 << 20)
    return {"up": mb / max(t1 - t0, 1e-9), "down": mb / max(t2 - t1, 1e-9)}


def link_bandwidth_mbps(device=None) -> float:
    """Host<->device rate in MB/s for the run's ``device`` (the slower
    direction of :func:`measure_link`), measured once per card and
    process.  ``ALIGNGRAPH2_TPU_TORCH_LINK_MBPS`` overrides it; 0.0 on the
    CPU and without a card."""
    env = os.environ.get(LINK_VAR)
    if env:
        return float(env)
    dev = _card(device)
    if dev is None:
        return 0.0
    if dev.index not in _cached_mbps:
        rates = measure_link(dev)
        _cached_mbps[dev.index] = min(rates.values())
        logger.info("device link probe: up %.0f MB/s, down %.0f MB/s",
                    rates["up"], rates["down"])
    return _cached_mbps[dev.index]


def resolve_backend(env_var: str, device=None) -> str:
    """The value of switch ``env_var`` for a run on ``device``: an explicit
    value as it stands; ``auto`` (the default) by the rule of the module
    docstring."""
    val = os.environ.get(env_var, "auto")
    if val != "auto":
        return val
    if env_var == CONSENSUS_VAR:
        return "native"
    return ("device" if link_bandwidth_mbps(device) >= DEVICE_MIN_MBPS
            else "native")
