from .records import Alignment, AlignmentSet, parse_diff, exact_align_pairs

__all__ = ["Alignment", "AlignmentSet", "parse_diff", "exact_align_pairs"]
