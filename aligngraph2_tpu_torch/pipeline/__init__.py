from .cache import StageCache
from .preprocess import group_contigs
from .driver import run_pipeline

__all__ = ["StageCache", "group_contigs", "run_pipeline"]
