from .ttl import TTLCache
from .unavailable import UnavailableOfferings

# Cache TTLs (reference pkg/cache/cache.go:19-43)
DEFAULT_TTL = 60.0                    # 1 min
UNAVAILABLE_OFFERINGS_TTL = 180.0     # 3 min (ICE memory)
INSTANCE_TYPES_TTL = 300.0            # 5 min
INSTANCE_PROFILE_TTL = 900.0          # 15 min

__all__ = ["TTLCache", "UnavailableOfferings", "DEFAULT_TTL",
           "UNAVAILABLE_OFFERINGS_TTL", "INSTANCE_TYPES_TTL", "INSTANCE_PROFILE_TTL"]
