"""Introspection helpers the ported controllers use.

Only ``contention`` (the instrumented locks that the cluster mirror, the
batcher, the writer and the flight recorder take) is ported. The JAX
package's ``introspect/__init__.py`` also carries the process-wide stats
registry, the sampler, the SLO tracker, the profiler and the headroom
registry; they belong to the Operator and wait for it.
"""

from . import contention

__all__ = ["contention"]
