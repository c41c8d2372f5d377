from .selective_adam import SelectiveAdam

__all__ = ["SelectiveAdam"]
