from .pagraph import PAGraph, Grade, check_position

__all__ = ["PAGraph", "Grade", "check_position"]
