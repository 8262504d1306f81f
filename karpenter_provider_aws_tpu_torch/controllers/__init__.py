"""Controllers. The provisioner and the lifecycle (registration)
controller are ported; garbage collection, termination, disruption,
tagging and the nodeclass controller wait for the Operator."""

from .provisioning import Provisioner
from .lifecycle import LifecycleController

__all__ = ["Provisioner", "LifecycleController"]
