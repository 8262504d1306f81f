from .messages import (
    InterruptionMessage, MessageKind, parse_message,
    rebalance_recommendation, scheduled_change, spot_interruption, state_change,
)
from .queue import FakeQueue, QueueMessage
from .controller import InterruptionController

__all__ = ["InterruptionController", "FakeQueue", "QueueMessage",
           "InterruptionMessage", "MessageKind", "parse_message",
           "spot_interruption", "rebalance_recommendation", "scheduled_change",
           "state_change"]
