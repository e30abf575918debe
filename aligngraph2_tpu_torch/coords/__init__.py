from .mapper import PositionMapper

__all__ = ["PositionMapper"]
