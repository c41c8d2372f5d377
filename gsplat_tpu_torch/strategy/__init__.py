from .base import Strategy
from .default import DefaultStrategy
from .mcmc import MCMCStrategy

__all__ = ["Strategy", "DefaultStrategy", "MCMCStrategy"]
