"""Cloud and solver error taxonomy (the JAX package's ``errors.py``).

The cloud errors classify what a cloud backend's launch can fail with
(not-found, already-exists, unfulfillable capacity, rate limits). The
solver feedback loop hangs off ``UnfulfillableCapacityError``: each
(capacity_type, instance_type, zone) offering it names is masked out of
the next solve through the UnavailableOfferings cache.

The device solve can fail in ways a plan cannot express: a bin table that
cannot grow past its top bucket, or a failed kernel launch or device
allocation. Each failure surfaces to the caller as one of these classes;
this package has no degradation ladder that would turn them into a
host-computed plan.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

Offering = Tuple[str, str, str]  # (capacity_type, instance_type, zone)


class CloudError(Exception):
    """Base class for cloud backend errors."""


class NotFoundError(CloudError):
    pass


class AlreadyExistsError(CloudError):
    pass


@dataclass
class UnfulfillableCapacityError(CloudError):
    """Insufficient capacity for every offering attempted (the ICE case)."""

    offerings: List[Offering]

    def __post_init__(self):
        super().__init__(f"insufficient capacity for {len(self.offerings)} offering(s)")


class RateLimitedError(CloudError):
    pass


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


def is_retryable_solver_error(err: BaseException) -> bool:
    return isinstance(err, SolverError) and err.retryable


def is_not_found(err: BaseException) -> bool:
    return isinstance(err, NotFoundError)


def is_already_exists(err: BaseException) -> bool:
    return isinstance(err, AlreadyExistsError)


def is_unfulfillable_capacity(err: BaseException) -> bool:
    return isinstance(err, UnfulfillableCapacityError)
