from .cluster import ClusterState, DirtyJournalCoalescer, DirtySet

__all__ = ["ClusterState", "DirtyJournalCoalescer", "DirtySet"]
