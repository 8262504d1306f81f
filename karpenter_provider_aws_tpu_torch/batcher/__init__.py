from .batcher import Batcher, BatcherOptions
from .solve_window import SolveWindow, SOLVE_WINDOW_OPTIONS

__all__ = ["Batcher", "BatcherOptions", "SolveWindow",
           "SOLVE_WINDOW_OPTIONS"]
