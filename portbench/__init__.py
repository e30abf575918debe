"""The benchmark of the PyTorch and CUDA port (``aligngraph2_tpu_torch``):
the card's alignment stages as streamed jobs.  Run ``python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the repository's root."""
