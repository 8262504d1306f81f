from .operator import Operator
from .options import Options

__all__ = ["Operator", "Options"]
