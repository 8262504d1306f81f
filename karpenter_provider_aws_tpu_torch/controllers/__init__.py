"""Controllers. The provisioner, the lifecycle (registration), termination
and disruption controllers are ported; garbage collection, tagging and the
nodeclass controller wait for the Operator."""

from .provisioning import Provisioner
from .lifecycle import LifecycleController
from .termination import TerminationController
from .disruption import DisruptionController

__all__ = ["Provisioner", "LifecycleController", "TerminationController",
           "DisruptionController"]
