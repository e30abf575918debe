"""Host backend switches of the graph merge and the consensus.

Stands in for ``aligngraph2_tpu/utils/devprobe.py::resolve_backend``
without the probe: each switch is an environment variable whose value
names the backend, ``native`` (the C++ core) by default.  ``device``
names the torch-op path on the run's device (``graph/merge_device.py``,
``consensus/device.py``).  There is no ``auto`` value: nothing measures
the link to pick one.
"""

from __future__ import annotations

import os
from typing import Sequence


def resolve_backend(env_var: str, choices: Sequence[str]) -> str:
    """The value of ``env_var`` (default ``native``), one of ``choices``;
    any other value raises ValueError."""
    val = os.environ.get(env_var, "native")
    if val not in choices:
        raise ValueError(f"{env_var}={val!r}: expected one of "
                         f"{', '.join(choices)}")
    return val
