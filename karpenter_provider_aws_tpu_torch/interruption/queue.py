"""Interruption event queue.

Mirror of the reference's SQS provider (reference pkg/providers/sqs/sqs.go:
52-72: 20 s long-poll receive, max 10 messages, delete on handled). The
fake is the default backend of the simulation environment; a real
deployment implements the same three-method surface over its message bus.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

MAX_MESSAGES = 10        # sqs.go MaxNumberOfMessages
WAIT_TIME_SECONDS = 20   # sqs.go WaitTimeSeconds (long poll)


@dataclass
class QueueMessage:
    id: str
    body: Dict
    receipt_handle: str


class FakeQueue:
    """In-memory queue with SQS receive/delete semantics (at-least-once:
    received messages stay until deleted). A deque of ids carries receive
    order; deleted ids are dropped lazily off the front and compacted when
    they dominate, so a 15k-message FIFO drain (the reference's
    interruption benchmark depth, interruption_benchmark_test.go:61-75)
    is amortized O(batch) per receive and O(1) per delete — never
    quadratic on the queue itself."""

    def __init__(self, name: str = "interruption-queue"):
        self.name = name
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._messages: Dict[str, QueueMessage] = {}
        self._pending: Deque[str] = deque()

    def send(self, body: Dict) -> str:
        with self._lock:
            mid = f"m-{next(self._ids):06d}"
            self._messages[mid] = QueueMessage(id=mid, body=body, receipt_handle=mid)
            self._pending.append(mid)
            return mid

    def receive(self, max_messages: int = MAX_MESSAGES) -> List[QueueMessage]:
        """Non-blocking receive, oldest first (the sim loop polls; a live
        deployment long-polls for WAIT_TIME_SECONDS). Received messages are
        re-delivered until deleted."""
        with self._lock:
            while self._pending and self._pending[0] not in self._messages:
                self._pending.popleft()
            if len(self._pending) > 2 * len(self._messages):
                # out-of-order deletes left dead ids mid-deque: compact
                self._pending = deque(
                    m for m in self._pending if m in self._messages)
            out = []
            for mid in self._pending:
                msg = self._messages.get(mid)
                if msg is not None:
                    out.append(msg)
                    if len(out) >= max_messages:
                        break
            return out

    def delete(self, receipt_handle: str) -> None:
        with self._lock:
            self._messages.pop(receipt_handle, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._messages)

    def reset(self) -> None:
        with self._lock:
            self._messages.clear()
            self._pending.clear()
