"""On a CUDA card: the graph-stages job's control (stage 7's reference
with half the band, ``control_graph.py``) at the cell's own size must come
out not correct on three seeds: the E. coli deployment under the
``graph.single`` traffic.  Each seed runs the program's set-up (the
eight stages from an empty cache) and the reference twice over the
window's sample: about four minutes a seed.  Run on the card with

    python -m pytest portbench/tests/test_portbench_graph_card.py -q

Skips without a card."""

import pytest
import torch

from portbench import control_graph

SEEDS = (2 ** 31 + 111, 2 ** 31 + 222, 2 ** 31 + 333)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_graph_control_fails_at_cell_size(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = control_graph.files_spec("ecoli_k12_pacbio", "graph.single")
    [out] = control_graph.control(spec, seed, torch.device("cuda"))
    assert not out["correct"], out
