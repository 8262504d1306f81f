"""CloudProvider metrics decoration.

Mirror of the reference's `metrics.Decorate(cloudProvider)`
(reference cmd/controller/main.go:44): every CloudProvider method call is
wrapped with a duration histogram and an error counter
(karpenter_cloudprovider_duration_seconds /
karpenter_cloudprovider_errors_total, website reference/metrics.md:175).
Non-decorated attributes proxy through, so the decorated provider is a
drop-in at the plugin seam.
"""

from __future__ import annotations

import time
from typing import Optional

from ..metrics import Registry

_DECORATED = ("create", "delete", "get", "list_instances", "get_instance_types",
              "is_drifted")


class MetricsDecoratedCloudProvider:
    def __init__(self, inner, registry: Registry, controller: str = "operator"):
        self._inner = inner
        self._controller = controller
        self._duration = registry.histogram(
            "karpenter_cloudprovider_duration_seconds",
            "Duration of cloud provider method calls.", ("controller", "method"))
        self._errors = registry.counter(
            "karpenter_cloudprovider_errors_total",
            "Total number of errors returned from CloudProvider calls.",
            ("controller", "method", "error"))
        for name in _DECORATED:
            setattr(self, name, self._wrap(name))

    def _wrap(self, name: str):
        fn = getattr(self._inner, name)
        duration, errors, controller = self._duration, self._errors, self._controller

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                errors.inc(controller=controller, method=name, error=type(e).__name__)
                raise
            finally:
                duration.observe(time.perf_counter() - t0,
                                 controller=controller, method=name)
        wrapped.__name__ = name
        return wrapped

    def __getattr__(self, item):
        return getattr(self._inner, item)


def decorate(cloud_provider, registry: Optional[Registry],
             controller: str = "operator"):
    if registry is None:
        return cloud_provider
    return MetricsDecoratedCloudProvider(cloud_provider, registry, controller)
