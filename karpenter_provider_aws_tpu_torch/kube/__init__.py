"""Kubernetes-object write seam (the port's kube subpackage holds only
the simulation-stratum writer; the API stratum waits for the Operator)."""

from .writer import DirectWriter, FencedWriteError, WriterCounts

__all__ = ["DirectWriter", "FencedWriteError", "WriterCounts"]
