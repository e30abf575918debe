from .timing import StageTimer, Progress

__all__ = ["StageTimer", "Progress"]
