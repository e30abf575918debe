from .poa import AlnGraph, normalize_gaps
from .window import consensus_backbone, slice_into_windows, weight_alignments

__all__ = ["AlnGraph", "normalize_gaps", "consensus_backbone",
           "slice_into_windows", "weight_alignments"]
