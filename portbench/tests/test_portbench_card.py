"""On a CUDA card: the control (half the band) at each cell's own size
must come out not correct on three seeds.  The control is the reference
in the program's place on one card, so a four-card cell reads it there
too, over its own window's sample.  Run on the card with

    python -m pytest portbench/tests/test_portbench_card.py -q

(each seed makes the cell's deployment and runs the reference twice over
the window's sample: about a minute and a half a seed).  Skips without a
card."""

import pytest
import torch

from portbench import control, harness

# the reads a window of the cell finishes at run_seconds (PERF.md)
WINDOW_READS = {"scer.r2r.mesh1": 10240,
                "scer.r2r.mesh4": 20480}
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(WINDOW_READS))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_at_cell_size(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    [out] = control.control(spec, seed, WINDOW_READS[cell],
                            torch.device("cuda"), kinds=["band_half"])
    assert not out["correct"], out
