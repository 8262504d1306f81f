"""Leader election — the controller-HA half of the operator runtime.

The reference deploys 2 controller replicas behind Kubernetes
coordination/v1 lease-based leader election (client-go leaderelection;
the helm chart's PDB keeps one alive through node maintenance) and gates
side-effectful startup work on winning the lease (reference
pkg/providers/launchtemplate/launchtemplate.go:100-108 hydrates its cache
"after leader election"). This is the same algorithm over a pluggable
lease store:

- acquire when the lease is unheld or its renew time is older than the
  lease duration (the previous holder died),
- renew while holding; a holder that cannot renew within the lease
  duration loses leadership and must stop acting,
- release on clean shutdown so a standby takes over immediately.

Stores: :class:`MemoryLeaseStore` for simulation/tests (the FakeCloud
analog of the coordination API) and :class:`FileLeaseStore` for real
multi-process deployments on a shared filesystem (atomic rename swap).

Handoff extensions (docs/reference/handoff.md): the lease carries a
monotonic FENCING TOKEN that bumps on every takeover, so a demoted
(zombie) leader's in-flight side effects are rejected against the store
instead of raced (:class:`FenceGuard`, threaded through kube/writer.py);
takeover is gated on the standby's bounded-staleness check
(``promotion_gate`` — state/replication.py ``promotion_ready``), and the
False→True transition fires ``on_promote`` (the orphaned-lease sweep).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

from ..utils.clock import Clock
from ..utils.logging import get_logger

log = get_logger("leaderelection")

LEASE_DURATION = 15.0   # client-go defaults: 15s lease
RETRY_PERIOD = 2.0      # acquire/renew cadence


@dataclass
class Lease:
    holder: str
    renew_time: float
    # the fencing token: +1 on every TAKEOVER (never on renewal), so any
    # write stamped with an older fence provably predates the current
    # leader's term. Old stores/files without the field read as 0.
    fence: int = 0


class MemoryLeaseStore:
    """In-memory lease record with compare-and-swap semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lease: Optional[Lease] = None

    def get(self) -> Optional[Lease]:
        with self._lock:
            return self._lease

    def swap(self, expect_holder: Optional[str], lease: Optional[Lease]) -> bool:
        """Write ``lease`` iff the current holder is ``expect_holder``
        (None = unheld/expired takeover is validated by the caller)."""
        with self._lock:
            current = self._lease.holder if self._lease else None
            if current != expect_holder:
                return False
            self._lease = lease
            return True


class FileLeaseStore:
    """Lease in a JSON file, swapped atomically via rename. Suitable for
    replicas sharing a filesystem. The compare and the write run under an
    exclusive flock on a sidecar lockfile, so two replicas cannot
    interleave the read-check-write and both believe they won (the
    dual-leader window the pre-lock implementation had); a real cluster
    deployment still uses the coordination API (ApiLeaseStore)."""

    def __init__(self, path: str):
        self.path = Path(path)
        self._lockpath = self.path.with_name(self.path.name + ".lock")
        # crash-safety observability: a truncated/zero-byte/garbage lease
        # file reads as "unheld" (counted, warned once) — never an
        # exception out of the election tick
        self.corrupt_reads = 0
        self._warned_corrupt = False

    def get(self) -> Optional[Lease]:
        try:
            text = self.path.read_text()
        except OSError:
            return None   # no file (or unreadable): unheld
        try:
            d = json.loads(text)
            holder = d["holder"]
            if not isinstance(holder, str):
                raise ValueError("non-string holder")
            return Lease(holder=holder, renew_time=float(d["renewTime"]),
                         fence=int(d.get("fence", 0)))
        except (ValueError, KeyError, TypeError):
            # a writer crashed mid-write (zero-byte file), the JSON is
            # truncated, or the body is the wrong shape (TypeError: a
            # JSON scalar/array has no ["holder"]): the lease reads as
            # UNHELD so the election proceeds over the wreckage instead
            # of the tick raising and killing the runtime
            self.corrupt_reads += 1
            if not self._warned_corrupt:
                self._warned_corrupt = True
                log.warning("corrupt lease file treated as unheld",
                            path=str(self.path))
            return None

    def swap(self, expect_holder: Optional[str], lease: Optional[Lease]) -> bool:
        import fcntl
        with open(self._lockpath, "w") as lockf:
            fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
            try:
                current = self.get()
                if (current.holder if current else None) != expect_holder:
                    return False
                if lease is None:
                    try:
                        self.path.unlink()
                    except OSError:
                        pass
                    return True
                fd, tmp = tempfile.mkstemp(dir=str(self.path.parent))
                with os.fdopen(fd, "w") as f:
                    json.dump({"holder": lease.holder,
                               "renewTime": lease.renew_time,
                               "fence": lease.fence}, f)
                os.replace(tmp, self.path)
                return True
            finally:
                fcntl.flock(lockf.fileno(), fcntl.LOCK_UN)


class LeaderElector:
    def __init__(self, store, identity: str,
                 lease_duration: float = LEASE_DURATION,
                 clock: Optional[Clock] = None,
                 promotion_gate: Optional[Callable[[], bool]] = None,
                 on_promote: Optional[Callable[[], None]] = None):
        self.store = store
        self.identity = identity
        self.lease_duration = lease_duration
        self.clock = clock or Clock()
        self._leading = False
        self.transitions = 0   # leadership changes observed (metrics hook)
        # the fence this elector holds while leading (handoff fencing):
        # set from the lease on renew, bumped on takeover
        self.fence = 0
        # bounded-staleness cutover: a standby may only TAKE OVER once
        # its replica passes the gate (state/replication.py
        # promotion_ready — journal-anchor staleness check). Renewal is
        # never gated: an incumbent must not lose its own lease to a
        # transient replication hiccup.
        self.promotion_gate = promotion_gate
        self.on_promote = on_promote
        self.promotions_blocked = 0
        self.promote_hook_errors = 0

    @property
    def is_leader(self) -> bool:
        return self._leading

    def try_acquire_or_renew(self) -> bool:
        """One election tick; returns current leadership. Call every
        RETRY_PERIOD (the runtime registers this as its own controller)."""
        now = self.clock.now()
        lease = self.store.get()
        if lease is not None and lease.holder == self.identity:
            ok = self.store.swap(self.identity,
                                 Lease(self.identity, now, lease.fence))
            if ok:
                self.fence = lease.fence
            self._set(ok)
            return self._leading
        if lease is None or now - lease.renew_time >= self.lease_duration:
            # unheld, or the holder stopped renewing: take over — but
            # only through the promotion gate (a standby with no usable
            # snapshot must leave the lease on the floor rather than
            # promote an empty mirror)
            if self.promotion_gate is not None and not self.promotion_gate():
                self.promotions_blocked += 1
                self._set(False)
                return False
            expect = lease.holder if lease is not None else None
            fence = (lease.fence if lease is not None else 0) + 1
            ok = self.store.swap(expect, Lease(self.identity, now, fence))
            if ok:
                self.fence = fence
            self._set(ok and self.store.get().holder == self.identity)
            return self._leading
        self._set(False)
        return False

    def release(self) -> None:
        """Clean shutdown: drop the lease so a standby wins immediately."""
        if self._leading:
            self.store.swap(self.identity, None)
            self._set(False)

    def holds_fence(self) -> bool:
        """True iff THE STORE still shows this identity holding the
        lease at the fence this elector acquired. Re-reads the store —
        a zombie whose election thread has not ticked (hung process)
        still fails here the instant a standby's takeover rotates the
        token. The authoritative check behind :class:`FenceGuard`."""
        if not self._leading:
            return False
        lease = self.store.get()
        return (lease is not None and lease.holder == self.identity
                and lease.fence == self.fence)

    def fence_guard(self) -> "FenceGuard":
        return FenceGuard(self)

    def _set(self, leading: bool) -> None:
        if leading != self._leading:
            self.transitions += 1
            self._leading = leading
            if leading and self.on_promote is not None:
                # promotion side effects (orphaned-lease sweep,
                # introspection re-wire) must never cost the new leader
                # its first election tick
                try:
                    self.on_promote()
                except Exception as e:  # noqa: BLE001
                    self.promote_hook_errors += 1
                    log.warning("on_promote hook failed",
                                error=f"{type(e).__name__}: {e}")
            return
        self._leading = leading


class FenceGuard:
    """The write-side fencing check (threaded through kube/writer.py
    ``set_fence``): every side-effectful verb asks ``check()`` first,
    and a False answer raises ``FencedWriteError`` at the verb — a
    demoted leader's queued eviction/claim write is REJECTED against
    the store, not raced against the new leader's."""

    def __init__(self, elector: LeaderElector):
        self._elector = elector
        self.checks = 0
        self.rejections = 0

    def check(self) -> bool:
        self.checks += 1
        ok = self._elector.holds_fence()
        if not ok:
            self.rejections += 1
        return ok

    @property
    def fence(self) -> int:
        return self._elector.fence

    def stats(self) -> dict:
        return {"checks": self.checks, "rejections": self.rejections,
                "fence": self._elector.fence}


class ApiLeaseStore:
    """Lease in the apiserver's coordination resource — true
    client-go-style election: compare-and-swap rides the server's
    optimistic concurrency (a stale resourceVersion on update = lost the
    race), exactly how the reference's replicas elect through the
    coordination/v1 API. Election leases carry ``"election": true`` so
    the StateSync lease applier keeps them OUT of the kube-node-lease
    mirror (they would otherwise be reaped as ownerless by the lease GC —
    the namespace separation the real cluster gives for free)."""

    NAME = "karpenter-tpu-leader-election"

    def __init__(self, server, name: str = NAME):
        self.server = server
        self.name = name

    def get(self) -> Optional[Lease]:
        from ..kube.apiserver import NotFoundError
        try:
            spec = self.server.get("leases", self.name)["spec"]
        except NotFoundError:
            return None
        if spec.get("holder") is None:
            return None
        return Lease(holder=spec["holder"],
                     renew_time=float(spec["renewTime"]),
                     fence=int(spec.get("fence", 0)))

    def swap(self, expect_holder: Optional[str],
             lease: Optional[Lease]) -> bool:
        from ..kube.apiserver import (AlreadyExistsError, ConflictError,
                                      NotFoundError)
        try:
            obj = self.server.get("leases", self.name)
        except NotFoundError:
            if expect_holder is not None:
                return False
            if lease is None:
                return True
            try:
                self.server.create("leases", {
                    "name": self.name, "election": True,
                    "holder": lease.holder, "renewTime": lease.renew_time,
                    "fence": lease.fence})
                return True
            except AlreadyExistsError:
                return False   # lost the creation race
        if obj["spec"].get("holder") != expect_holder:
            return False
        # get() returns the frozen shared envelope (kube/apiserver.py
        # copy-on-read discipline) — deepcopy thaws a mutable CAS copy
        import copy
        obj = copy.deepcopy(obj)
        if lease is None:
            # release: clear the holder (keep the object — its RV history
            # stays useful and re-creation races disappear)
            obj["spec"]["holder"] = None
            obj["spec"]["renewTime"] = 0.0
        else:
            obj["spec"]["holder"] = lease.holder
            obj["spec"]["renewTime"] = lease.renew_time
            obj["spec"]["fence"] = lease.fence
        try:
            self.server.update("leases", obj)
            return True
        except (ConflictError, NotFoundError):
            return False   # another replica wrote first: CAS failed
