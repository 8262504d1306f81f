"""Kubernetes-object write seam (the port's kube subpackage holds only
the simulation-stratum writer, which the Operator's direct mode uses; the
API stratum is not ported)."""

from .writer import DirectWriter, FencedWriteError, WriterCounts

__all__ = ["DirectWriter", "FencedWriteError", "WriterCounts"]
