"""Sort and run helpers shared by the device merge and the device
consensus (torch ops on any device)."""

from __future__ import annotations

from typing import Sequence

import torch


def stable_lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The stable permutation that sorts by ``keys[0]``, then
    ``keys[1]``, ...: one stable sort per key, the last key first."""
    order = None
    for key in reversed(keys):
        k = key if order is None else key[order]
        idx = torch.sort(k, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def run_starts(same: torch.Tensor) -> torch.Tensor:
    """Bool mask of the rows that open a run: row 0, and row i where
    ``same[i - 1]`` (row i equal to row i - 1) is false."""
    out = torch.ones(same.numel() + 1, dtype=torch.bool, device=same.device)
    out[1:] = ~same
    return out
