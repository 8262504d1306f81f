"""Solver error taxonomy (the solver half of the JAX package's
``errors.py``).

The device solve can fail in ways a plan cannot express: a bin table that
cannot grow past its top bucket, or a failed kernel launch or device
allocation. Each failure surfaces to the caller as one of these classes;
this package has no degradation ladder that would turn them into a
host-computed plan.
"""

from __future__ import annotations


class SolverError(Exception):
    """Base class for solver-path failures. ``retryable`` says whether
    re-running the SAME path with the SAME input could succeed."""

    retryable = False


class SolverCapacityError(SolverError):
    """The problem exceeds a structural ceiling of the device path (group
    bucket, bin-table growth exhausted). Retrying the same path cannot
    help."""

    retryable = False

    def __init__(self, message: str, axis: str = ""):
        super().__init__(message)
        self.axis = axis   # "G" | "B" | "" — which ceiling was hit


class SolverDeviceError(SolverError):
    """The device call itself failed (kernel launch error, device OOM,
    transfer failure)."""

    retryable = True

    def __init__(self, message: str, cause: BaseException = None):
        super().__init__(message)
        self.cause = cause
