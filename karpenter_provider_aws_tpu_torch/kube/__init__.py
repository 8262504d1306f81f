"""Kubernetes-API-shaped ingest seam: fake apiserver, typed client,
informers (reference pkg/operator/operator.go manager + client wiring;
pkg/test/environment.go envtest stratum)."""

from .apiserver import (
    AlreadyExistsError, APIError, ConflictError, EvictionBlockedError,
    FakeAPIServer, InvalidObjectError, NotFoundError, TooOldError, Watch,
    WatchEvent,
)
from .client import (
    KubeClient, TERMINATION_FINALIZER, install_admission,
    install_default_indexes,
)
from .informer import Informer, InformerSet
from .httpserver import serve as serve_http

__all__ = [
    "APIError", "AlreadyExistsError", "ConflictError",
    "EvictionBlockedError", "FakeAPIServer", "Informer", "InformerSet",
    "InvalidObjectError", "KubeClient", "NotFoundError",
    "TERMINATION_FINALIZER", "TooOldError", "Watch", "WatchEvent",
    "install_admission", "install_default_indexes", "serve_http",
]
