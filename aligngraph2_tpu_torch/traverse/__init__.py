from .walk import TravelState, travel_sequence, seq_to_string, seq_size
from .assembly import assemble_group, AssemblyResult

__all__ = ["TravelState", "travel_sequence", "seq_to_string", "seq_size",
           "assemble_group", "AssemblyResult"]
