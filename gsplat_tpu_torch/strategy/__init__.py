from .base import Strategy
from .default import DefaultStrategy

__all__ = ["Strategy", "DefaultStrategy"]
