from .provisioning import Provisioner
from .lifecycle import LifecycleController
from .garbagecollection import GarbageCollectionController
from .termination import TerminationController
from .disruption import DisruptionController
from .tagging import TaggingController

__all__ = ["Provisioner", "LifecycleController", "GarbageCollectionController",
           "TerminationController", "DisruptionController", "TaggingController"]
