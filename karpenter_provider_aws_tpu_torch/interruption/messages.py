"""Interruption message schemas + parser registry.

Mirror of the reference's four EventBridge schemas and its registry keyed
on (version, source, detail-type) (reference
pkg/controllers/interruption/messages/* and parser.go:53-93):

- spot interruption warning       (2-minute notice)
- rebalance recommendation        (observational; NoAction)
- scheduled change / health event (degraded hardware etc.)
- instance state change           (stopping / terminating)

Unknown (source, detail-type) parses to a NoOp message rather than an
error, like the reference's default parser.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class MessageKind(str, enum.Enum):
    SPOT_INTERRUPTION = "SpotInterruptionKind"
    REBALANCE_RECOMMENDATION = "RebalanceRecommendationKind"
    SCHEDULED_CHANGE = "ScheduledChangeKind"
    STATE_CHANGE = "StateChangeKind"
    NOOP = "NoOpKind"
    # a body that is not a dict, or that matched a registered parser but
    # blew it up (missing/mistyped detail fields): counted and dropped —
    # distinct from NOOP (a well-formed message we deliberately ignore)
    # so the karpenter_interruption_messages_total{kind="malformed"}
    # series can alarm on a misconfigured event rule
    MALFORMED = "MalformedKind"


# metric label values per kind (karpenter_interruption_messages_total)
KIND_LABELS = {
    MessageKind.SPOT_INTERRUPTION: "spot-interruption",
    MessageKind.REBALANCE_RECOMMENDATION: "rebalance-recommendation",
    MessageKind.SCHEDULED_CHANGE: "scheduled-change",
    MessageKind.STATE_CHANGE: "state-change",
    MessageKind.NOOP: "noop",
    MessageKind.MALFORMED: "malformed",
}


@dataclass(frozen=True)
class InterruptionMessage:
    kind: MessageKind
    instance_ids: Tuple[str, ...]
    source: str = ""
    detail_type: str = ""
    detail: Dict = field(default_factory=dict)


# ---- message constructors (what the cloud's event bridge would emit) ----

def spot_interruption(instance_id: str) -> Dict:
    return {
        "version": "0", "source": "aws.ec2",
        "detail-type": "EC2 Spot Instance Interruption Warning",
        "detail": {"instance-id": instance_id, "instance-action": "terminate"},
    }


def rebalance_recommendation(instance_id: str) -> Dict:
    return {
        "version": "0", "source": "aws.ec2",
        "detail-type": "EC2 Instance Rebalance Recommendation",
        "detail": {"instance-id": instance_id},
    }


def scheduled_change(*instance_ids: str) -> Dict:
    return {
        "version": "0", "source": "aws.health",
        "detail-type": "AWS Health Event",
        "detail": {
            "service": "EC2", "eventTypeCategory": "scheduledChange",
            "affectedEntities": [{"entityValue": i} for i in instance_ids],
        },
    }


def state_change(instance_id: str, state: str = "stopping") -> Dict:
    return {
        "version": "0", "source": "aws.ec2",
        "detail-type": "EC2 Instance State-change Notification",
        "detail": {"instance-id": instance_id, "state": state},
    }


# ---- parser registry (parser.go:53-93) ----------------------------------

def _parse_spot(body: Dict) -> InterruptionMessage:
    return InterruptionMessage(
        kind=MessageKind.SPOT_INTERRUPTION,
        instance_ids=(body["detail"]["instance-id"],),
        source=body["source"], detail_type=body["detail-type"], detail=body["detail"])


def _parse_rebalance(body: Dict) -> InterruptionMessage:
    return InterruptionMessage(
        kind=MessageKind.REBALANCE_RECOMMENDATION,
        instance_ids=(body["detail"]["instance-id"],),
        source=body["source"], detail_type=body["detail-type"], detail=body["detail"])


def _parse_scheduled(body: Dict) -> InterruptionMessage:
    # only EC2 scheduled changes / account-specific health events act on nodes
    detail = body.get("detail", {})
    if detail.get("service") != "EC2":
        return InterruptionMessage(kind=MessageKind.NOOP, instance_ids=())
    ids = tuple(e.get("entityValue", "") for e in detail.get("affectedEntities", ())
                if e.get("entityValue"))
    return InterruptionMessage(
        kind=MessageKind.SCHEDULED_CHANGE, instance_ids=ids,
        source=body["source"], detail_type=body["detail-type"], detail=detail)


# stopping/terminating act; running/pending etc. are NoOps (statechange pkg)
_ACTIONABLE_STATES = {"stopping", "stopped", "shutting-down", "terminated"}


def _parse_state_change(body: Dict) -> InterruptionMessage:
    detail = body.get("detail", {})
    if detail.get("state") not in _ACTIONABLE_STATES:
        return InterruptionMessage(kind=MessageKind.NOOP, instance_ids=())
    return InterruptionMessage(
        kind=MessageKind.STATE_CHANGE,
        instance_ids=(detail["instance-id"],),
        source=body["source"], detail_type=body["detail-type"], detail=detail)


_PARSERS = {
    ("aws.ec2", "EC2 Spot Instance Interruption Warning"): _parse_spot,
    ("aws.ec2", "EC2 Instance Rebalance Recommendation"): _parse_rebalance,
    ("aws.health", "AWS Health Event"): _parse_scheduled,
    ("aws.ec2", "EC2 Instance State-change Notification"): _parse_state_change,
}


def parse_message(body: Dict) -> InterruptionMessage:
    """Never raises. A non-dict body (the isinstance check runs BEFORE any
    ``body.get`` — a list/str body used to crash the noop construction
    itself) and a registered parser blowing up both classify as MALFORMED;
    an unknown (source, detail-type) pair is a well-formed NOOP, like the
    reference's default parser."""
    if not isinstance(body, dict):
        return InterruptionMessage(kind=MessageKind.MALFORMED, instance_ids=())
    parser = _PARSERS.get((body.get("source", ""), body.get("detail-type", "")))
    if parser is None:
        return InterruptionMessage(
            kind=MessageKind.NOOP, instance_ids=(),
            source=str(body.get("source", "")),
            detail_type=str(body.get("detail-type", "")))
    try:
        return parser(body)
    except Exception:
        # a malformed body must never poison the queue: classify it so the
        # controller counts + deletes it (the reference's parsers degrade
        # to a drop the same way)
        return InterruptionMessage(
            kind=MessageKind.MALFORMED, instance_ids=(),
            source=str(body.get("source", "")),
            detail_type=str(body.get("detail-type", "")))
