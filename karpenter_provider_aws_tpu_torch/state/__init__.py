from .cluster import DirtySet
