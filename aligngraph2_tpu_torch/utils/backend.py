"""Host backend switches of the graph merge and the consensus.

Each switch is an environment variable whose value names the backend:
``native`` (the C++ core), ``device`` (the torch-op path on the run's
device, ``graph/merge_device.py``, ``consensus/device.py``), the switch's
Python specification, or ``auto``, the default, which
``utils/devprobe.py`` resolves from the measured link to the run's
device.  Any other value raises.
"""

from __future__ import annotations

from typing import Sequence

from .devprobe import resolve_backend as _resolve


def resolve_backend(env_var: str, choices: Sequence[str],
                    device=None) -> str:
    """The backend switch ``env_var`` names for a run on ``device``, one of
    ``choices`` (``auto`` resolved); any other value raises ValueError."""
    val = _resolve(env_var, device)
    if val not in choices:
        raise ValueError(f"{env_var}={val!r}: expected one of "
                         f"{', '.join(choices)} or auto")
    return val
