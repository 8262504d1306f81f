from .batcher import Batcher, BatcherOptions

__all__ = ["Batcher", "BatcherOptions"]
