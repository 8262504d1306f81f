"""Interruption controller: queue events → ICE mask + cordon-and-drain.

Mirror of the reference controller (reference
pkg/controllers/interruption/controller.go:83-223): receive queue messages,
parse via the registry, map instance-id → NodeClaim, then

- spot interruption → mark the offering unavailable in the ICE cache
  (controller.go:194-200) AND cordon-and-drain,
- scheduled change / actionable state change → cordon-and-drain,
- rebalance recommendation → events/metrics only (NoAction,
  controller.go:291-296),

and delete the message. Draining deletes the NodeClaim, which the
termination controller turns into evict + instance terminate; the evicted
pods re-enter the next scheduling batch, whose solve already excludes the
ICE'd offering — proactive replacement before the 2-minute reclaim.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..apis import wellknown as wk
from ..apis.objects import NodeClaim
from ..cache.unavailable import UnavailableOfferings
from ..cloud.fake import parse_instance_id
from ..events import Recorder
from ..metrics import Registry, wire_core_metrics
from ..state.cluster import ClusterState
from ..utils.clock import Clock
from .messages import (InterruptionMessage, KIND_LABELS, MessageKind,
                       parse_message)
from .queue import FakeQueue

_ACTIONABLE = {MessageKind.SPOT_INTERRUPTION, MessageKind.SCHEDULED_CHANGE,
               MessageKind.STATE_CHANGE}
# kinds whose handler runs at all (rebalance publishes an event; noop and
# malformed bodies are counted + deleted without touching the cluster)
_HANDLED = _ACTIONABLE | {MessageKind.REBALANCE_RECOMMENDATION}


class InterruptionController:
    def __init__(self, queue: FakeQueue, cluster: ClusterState,
                 termination, unavailable: UnavailableOfferings,
                 recorder: Optional[Recorder] = None,
                 clock: Optional[Clock] = None,
                 metrics: Optional[Registry] = None):
        self.queue = queue
        self.cluster = cluster
        self.termination = termination
        self.unavailable = unavailable
        self.clock = clock or Clock()
        self.recorder = recorder or Recorder(self.clock)
        m = wire_core_metrics(metrics or Registry())
        self._m_received = m["interruption_received"]
        self._m_deleted = m["interruption_deleted"]
        self._m_actions = m["interruption_actions"]
        self._m_messages = m["interruption_messages"]
        # NOTE: karpenter_interruption_queue_depth is emitted by
        # Operator.emit_gauges from the headroom registry's reading
        # (introspect/headroom.py) — one source of truth for the depth,
        # never two code paths reporting different numbers
        # plain counters mirrored into stats() (the introspection
        # registry's "interruption" provider): per-kind totals plus the
        # two robustness signals a storm soak asserts on
        import threading
        self._stats_lock = threading.Lock()
        self._kind_counts: Dict[str, int] = {}
        self.handler_errors = 0
        self.poison_dropped = 0
        # per-message handler-failure counts (the SQS
        # ApproximateReceiveCount analog): a TRANSIENT handler failure
        # leaves the message in the queue for redelivery (at-least-once
        # holds — a 2-minute spot notice must not be lost to one cloud
        # hiccup), while a message that fails HANDLER_RETRY_LIMIT times
        # is a poison pill: counted and dropped so it can neither crash
        # nor wedge the loop. Entries are removed on delete, so the map
        # is bounded by live queue depth.
        self._attempts: Dict[str, int] = {}
        from ..utils.fanout import LazyPool
        self._pool = LazyPool(self.MESSAGE_WORKERS, "interruption-msg")

    HANDLER_RETRY_LIMIT = 3

    def _claims_by_instance_id(self) -> Dict[str, NodeClaim]:
        out: Dict[str, NodeClaim] = {}
        for claim in self.cluster.snapshot_claims():
            if claim.provider_id:
                out[parse_instance_id(claim.provider_id)] = claim
        return out

    # reference controller.go:104 fans message handling 10-way
    MESSAGE_WORKERS = 10

    def reconcile(self) -> int:
        """One receive→handle→delete pass (10-way parallel like
        workqueue.ParallelizeUntil, controller.go:104). Returns messages
        handled; the at-least-once contract holds — a message is deleted
        only after its handler ran, and a handler blow-up leaves it in
        the queue for redelivery. Malformed/unknown bodies and messages
        whose handler keeps failing (HANDLER_RETRY_LIMIT) are COUNTED
        and dropped: one poison pill can neither crash the controller
        loop nor wedge it via endless redelivery while a storm rages."""
        msgs = self.queue.receive()
        if not msgs:
            return 0
        claims_by_id = self._claims_by_instance_id()

        def one(qm) -> int:
            msg = parse_message(qm.body)   # never raises (messages.py)
            # the legacy received counter keeps true receive semantics
            # (one inc per delivery, redeliveries included)
            self._m_received.inc(message_type=msg.kind.value)
            if msg.kind in _HANDLED:
                try:
                    self._handle(msg, claims_by_id)
                except Exception:
                    with self._stats_lock:
                        self.handler_errors += 1
                        attempts = self._attempts.get(qm.id, 0) + 1
                        self._attempts[qm.id] = attempts
                    if attempts < self.HANDLER_RETRY_LIMIT:
                        # transient until proven otherwise: leave the
                        # message for redelivery (at-least-once)
                        return 0
                    with self._stats_lock:
                        self.poison_dropped += 1
            # the per-kind processed counters count on DISPOSAL (exactly
            # once per message), never per delivery — a transiently
            # retried message must not pad them (the soak's >100
            # interruptions-handled evidence sums these)
            label = KIND_LABELS[msg.kind]
            self._m_messages.inc(kind=label)
            with self._stats_lock:
                self._kind_counts[label] = \
                    self._kind_counts.get(label, 0) + 1
                self._attempts.pop(qm.id, None)
            self.queue.delete(qm.receipt_handle)
            self._m_deleted.inc()
            return 1

        n = sum(self._pool.run(msgs, one))
        return n

    def stats(self) -> Dict:
        """Introspection provider (docs/reference/introspection.md): queue
        depth plus per-kind message totals and the robustness counters."""
        with self._stats_lock:
            out: Dict = {f"received_{k.replace('-', '_')}": v
                         for k, v in self._kind_counts.items()}
            out["handler_errors"] = self.handler_errors
            out["poison_dropped"] = self.poison_dropped
        out["queue_depth"] = len(self.queue)
        return out

    def headroom_probe(self) -> Dict[str, float]:
        """Interruption backlog (introspect/headroom.py): undeleted
        messages. Unbounded (a real SQS queue buffers days), so the
        forecast rides the fill rate; drops = the pre-existing poison
        counter (the only way this controller ever discards)."""
        with self._stats_lock:
            poison = self.poison_dropped
        return {"depth": float(len(self.queue)), "capacity": 0.0,
                "drops": float(poison)}

    def _handle(self, msg: InterruptionMessage, claims_by_id: Dict[str, NodeClaim]) -> None:
        for iid in msg.instance_ids:
            claim = claims_by_id.get(iid)
            if claim is None:
                # event for an instance we don't manage — ignore (the
                # reference logs and drops, controller.go:249-289)
                continue
            if msg.kind == MessageKind.SPOT_INTERRUPTION:
                # remember the reclaimed pool so the replacement solve
                # avoids it (controller.go:194-200) — only when the claim
                # really is spot: a mislabeled event for an on-demand node
                # must not poison the spot pool for that type/zone
                if (claim.capacity_type == wk.CAPACITY_TYPE_SPOT
                        and claim.instance_type and claim.zone):
                    self.unavailable.mark_unavailable(
                        msg.kind.value, wk.CAPACITY_TYPE_SPOT,
                        claim.instance_type, claim.zone)
            self.recorder.publish(
                "Warning", msg.kind.value, "NodeClaim", claim.name,
                f"interruption event for instance {iid}")
            if msg.kind in _ACTIONABLE:
                self.termination.delete_claim(claim.name)
                self._m_actions.inc(action="CordonAndDrain")
