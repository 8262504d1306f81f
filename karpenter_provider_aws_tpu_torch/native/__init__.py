from .build import ensure_built, native_available
from .oracle import NativeOraclePlan, native_ffd_pack

__all__ = ["NativeOraclePlan", "ensure_built", "native_available",
           "native_ffd_pack"]
