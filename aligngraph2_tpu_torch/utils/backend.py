"""Host backend switches of the graph merge and the consensus.

Stands in for ``aligngraph2_tpu/utils/devprobe.py::resolve_backend``
without the probe: each switch is an environment variable whose value
names the backend, ``native`` (the C++ core) by default.  ``device``
names the path on the card, which comes with a later slice; until then
it raises instead of falling back.
"""

from __future__ import annotations

import os
from typing import Sequence


def resolve_backend(env_var: str, choices: Sequence[str],
                    device_item: str) -> str:
    """The value of ``env_var`` (default ``native``), one of ``choices``.
    ``device`` raises NotImplementedError naming ``device_item``, the
    ROADMAP item that ports it; any other value raises ValueError."""
    val = os.environ.get(env_var, "native")
    if val == "device":
        raise NotImplementedError(
            f"{env_var}=device: not ported yet ({device_item})")
    if val not in choices:
        raise ValueError(f"{env_var}={val!r}: expected one of "
                         f"{', '.join(choices)}")
    return val
