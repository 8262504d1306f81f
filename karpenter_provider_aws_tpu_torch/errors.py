"""Cloud and solver error taxonomy (the JAX package's ``errors.py``).

The cloud errors classify what a cloud backend's launch can fail with
(not-found, already-exists, unfulfillable capacity, rate limits). The
solver feedback loop hangs off ``UnfulfillableCapacityError``: each
(capacity_type, instance_type, zone) offering it names is masked out of
the next solve through the UnavailableOfferings cache.

The device solve can fail in ways a plan cannot express: a bin table that
cannot grow past its ceiling, or a failed kernel launch, device
allocation or transfer. The Solver's degradation ladder
(solver/solve.py ``_solve_problem``) reads these classes: a capacity
error goes straight to the host FFD, a device error is retried once
(``retryable``) and then lands there too, except on a CUDA device, where
only an ``injected`` one does and a real one raises. A real one after
which the device no longer runs a one-element probe is ``DeviceLostError``:
a sticky error (a device-side assert) took the CUDA context, so the
process must restart. A CUDA source that does not build or load raises
``KernelBuildError``, which no rung carries.
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

    def __init__(self, message: str, cause: BaseException = None,
                 injected: bool = False):
        super().__init__(message)
        self.cause = cause
        # raised by a FaultInjector (solver/faults.py), not by the device
        self.injected = injected


class DeviceLostError(SolverDeviceError):
    """A device error that outlived its retry, after which a one-element
    probe of the device (an op and a synchronize) fails too: a sticky
    error, such as a device-side assert, left the CUDA context unusable,
    and every later call on it fails. No retry and no rung helps; the
    Solver raises it from every later entry point, and the CLI ends the
    process with its own exit code so that the deployment restarts it
    with a fresh context."""

    retryable = False


# the exit code of a process whose Solver lost its device (the CLI and the
# solver sidecar): EX_TEMPFAIL, a failure that a restart with a fresh CUDA
# context may clear
EXIT_DEVICE_LOST = 75


class KernelBuildError(RuntimeError):
    """A CUDA source of the package did not compile or load (no ``nvcc``,
    a compiler error, a library the loader refuses). Not device weather:
    the same build fails again, so the ladder never retries it and no
    rung carries the solve."""


def is_retryable_solver_error(err: BaseException) -> bool:
    return isinstance(err, SolverError) and err.retryable


def is_not_found(err: BaseException) -> bool:
    return isinstance(err, NotFoundError)


def is_already_exists(err: BaseException) -> bool:
    return isinstance(err, AlreadyExistsError)


def is_unfulfillable_capacity(err: BaseException) -> bool:
    return isinstance(err, UnfulfillableCapacityError)
