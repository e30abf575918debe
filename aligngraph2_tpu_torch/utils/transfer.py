"""Host<->device copies of the device merge and the device consensus.

Every copy that ``graph/merge_device.py`` and ``consensus/device.py``
make goes through :func:`to_device` or :func:`to_host`, called through
this module, so that a caller can time the copies apart from the compute
(``chip_smoke.py`` wraps both).  On the CPU both share memory with their
input and copy nothing.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host."""
    return t.cpu().numpy()
