"""Threaded controller runtime — the controller-runtime analog.

The reference registers each controller with its own workqueue and
``MaxConcurrentReconciles`` (e.g. 10 for the NodeClass controller,
pkg/controllers/nodeclass/controller.go:298-305). Our controllers
reconcile the whole cluster per pass rather than per object, so the
mapping is: each controller ticks on its OWN cadence in its own thread
(never overlapping itself — the per-object serialization guarantee
collapses to per-controller), and different controllers run concurrently
against the locked ClusterState mirror.

The deterministic single-thread loop (Operator.run_once) remains the
test/simulation path; this runtime is the production serving loop behind
``karpenter-tpu-controller --async-runtime``.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class ControllerSpec:
    name: str
    reconcile: Callable[[], object]
    interval: float = 1.0          # seconds between the END of one pass
                                   # and the start of the next
    gate_on_leadership: bool = True  # False = runs on standbys too (the
                                     # informer pump: client-go reflectors
                                     # run on ALL replicas so a failover
                                     # starts from a warm mirror)


class ControllerRuntime:
    def __init__(self, specs: Sequence[ControllerSpec],
                 on_error: Optional[Callable[[str, BaseException], None]] = None,
                 elector=None):
        """``elector`` (operator/leaderelection.LeaderElector) gates every
        reconcile on holding the lease — the standby replica's controllers
        idle until it wins (the reference's client-go leader election
        around its manager). The election tick itself runs as one more
        controller thread registered here."""
        self.specs = list(specs)
        self.elector = elector
        if elector is not None:
            from .leaderelection import RETRY_PERIOD
            self.specs.append(ControllerSpec(
                "leader-election", elector.try_acquire_or_renew,
                interval=RETRY_PERIOD, gate_on_leadership=False))
        self._on_error = on_error
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._threads: List[threading.Thread] = []
        self.error_counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _run(self, spec: ControllerSpec) -> None:
        while not self._stop.is_set():
            if self._pause.is_set():
                # hung-operator chaos (weather OperatorKill mode="hang"):
                # nothing reconciles and — critically — the election tick
                # stops renewing, so the lease expires and a standby
                # promotes while this process still believes it leads.
                # resume() releases the queued work straight into the
                # write fence, where it is rejected, not raced.
                self._stop.wait(0.05)
                continue
            try:
                if (self.elector is None or not spec.gate_on_leadership
                        or self.elector.is_leader):
                    spec.reconcile()
            except BaseException as e:  # a controller crash must not kill
                with self._lock:       # its siblings (controller-runtime
                    self.error_counts[spec.name] = \
                        self.error_counts.get(spec.name, 0) + 1  # requeues)
                if self._on_error is not None:
                    self._on_error(spec.name, e)
                else:
                    traceback.print_exc()
            self._stop.wait(spec.interval)

    def start(self) -> "ControllerRuntime":
        # the threaded control plane is many short critical sections
        # under one GIL: at the default 5 ms switch interval, a lock
        # holder needing a few µs of interpreter time can be starved for
        # whole scheduling ROUNDS (15 threads × 5 ms ≈ 75 ms) under CPU
        # saturation — which reads as 100 ms+ lock waits on µs-scale
        # locks. A 1 ms interval trades a few percent of pure-Python
        # throughput for 5× tighter lock-wait tails (the SOAK_r08
        # contention acceptance measured exactly this). Restored by
        # stop(): the cost is for the threaded control plane's lifetime,
        # not the embedding process's.
        import sys
        if sys.getswitchinterval() > 0.001:
            self._prev_switch_interval = sys.getswitchinterval()
            sys.setswitchinterval(0.001)
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._run, args=(s,),
                             name=f"controller-{s.name}", daemon=True)
            for s in self.specs]
        for t in self._threads:
            t.start()
        return self

    def stop(self, timeout: float = 5.0) -> bool:
        """Signal every controller and join. Returns True when all threads
        exited; a thread still blocked (e.g. mid device solve) past the
        timeout stays tracked, so ``running`` keeps reporting True and a
        caller can stop() again rather than proceed over live mutation.
        A held lease is released so a standby takes over immediately."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
        # release only AFTER the election thread joined — releasing first
        # races its in-flight tick, which would re-acquire the lease and
        # orphan it on a dead process (standby then waits out the full
        # lease duration instead of taking over immediately)
        if self.elector is not None:
            self.elector.release()
        if not self._threads and getattr(self, "_prev_switch_interval",
                                         None) is not None:
            # the control plane's tightened GIL switch interval must not
            # outlive it in the embedding process
            import sys
            sys.setswitchinterval(self._prev_switch_interval)
            self._prev_switch_interval = None
        return not self._threads

    def crash_stop(self, timeout: float = 5.0) -> bool:
        """kill -9 semantics for chaos (weather OperatorKill
        mode="kill"): stop every thread WITHOUT releasing the lease — a
        crashed process never runs its shutdown path, so the standby
        must wait out the full lease duration before it may promote
        (the blackout window the orphaned-lease sweep cleans up after).
        The tightened switch interval is still restored: the embedding
        process lives on, only the operator 'died'."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
        if not self._threads and getattr(self, "_prev_switch_interval",
                                         None) is not None:
            import sys
            sys.setswitchinterval(self._prev_switch_interval)
            self._prev_switch_interval = None
        return not self._threads

    def pause(self) -> None:
        """Freeze every controller thread in place (OperatorKill
        mode="hang"): loops keep spinning but reconcile nothing,
        including the election tick — the hung-leader failure mode."""
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    @property
    def paused(self) -> bool:
        return self._pause.is_set()

    @property
    def running(self) -> bool:
        return any(t.is_alive() for t in self._threads)


def operator_specs(op) -> List[ControllerSpec]:
    """The production cadence map for an Operator's controllers (the
    reference's per-controller registration in controllers.go)."""
    specs = []
    if getattr(op, "sync", None) is not None:
        # API mode: the informer pump feeds the mirror continuously (its
        # own thread = the reflector goroutines of the reference manager).
        # NOT leadership-gated: standbys keep their mirror warm (and their
        # watch queues drained) so failover starts hot, like client-go
        # informers running on every replica
        specs.append(ControllerSpec("statesync", op.sync.sync_once,
                                    interval=0.05,
                                    gate_on_leadership=False))
    specs += [
        ControllerSpec("provisioning",
                       lambda: (op.provisioner.provision_once()
                                if op.provisioner.batch_ready() else None),
                       interval=0.2),
        ControllerSpec("nodeclass", op.nodeclass_controller.reconcile,
                       interval=10.0),
        ControllerSpec("pricing", op.pricing_controller.reconcile,
                       interval=60.0),
        ControllerSpec("lifecycle", op.lifecycle.reconcile, interval=1.0),
        ControllerSpec("tagging", op.tagging.reconcile, interval=5.0),
        ControllerSpec("disruption", op.disruption.reconcile, interval=10.0),
        ControllerSpec("termination", op.termination.reconcile, interval=1.0),
        ControllerSpec("gc", op.gc.reconcile, interval=60.0),
        ControllerSpec("ice-cleanup", op.unavailable.cleanup, interval=10.0),
        ControllerSpec("metrics", op.emit_gauges, interval=5.0),
    ]
    if op.interruption is not None:
        specs.append(ControllerSpec("interruption",
                                    op.interruption.reconcile, interval=1.0))
    return specs
