"""Cluster-state change sets.

The ``DirtySet`` half of the JAX package's ``state/cluster.py``: what
changed between two cluster-state revisions, which the incremental problem
builder (solver/incremental.py) reads to patch the previous problem
instead of rebuilding it. The cluster mirror that journals mutations into
these sets (``ClusterState``, its dirty journal and the journal
coalescer) is not ported yet; callers build ``DirtySet``s themselves.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Set


@dataclass
class DirtySet:
    """What changed between two cluster-state revisions. ``full`` means
    the journal could not answer (overflowed past ``since``) and the
    caller must rebuild from scratch — the always-correct fallback."""

    since: int
    rev: int
    full: bool = False
    pods: Set[str] = field(default_factory=set)   # names to re-examine
    bins: bool = False         # existing-bin inputs changed
    # node/claim names the bin mutations localized to, when the journal
    # entry carried one; ``bins_unnamed=True`` means at least one bin
    # mutation could NOT be localized, so per-name consumers must treat
    # the whole bin table as dirty — never a silently-partial answer
    bin_names: Set[str] = field(default_factory=set)
    bins_unnamed: bool = False
    volumes: bool = False      # PVC / StorageClass mutations
    daemonsets: bool = False   # daemonset pod set changed (ds_overhead)
    other: bool = False        # anything the journal cannot localize
    # journal drains merged into this set: >1 means several ticks were
    # coalesced into one delta
    ticks: int = 1

    def merge(self, newer: "DirtySet") -> None:
        """Fold a LATER drain into this one. Valid only when ``newer``
        continues exactly where this set ends (newer.since == rev), so
        the merged set covers (self.since, newer.rev] with no gap."""
        if newer.since != self.rev:
            raise ValueError(f"non-contiguous journal drains: this set ends "
                             f"at {self.rev}, the newer starts at {newer.since}")
        self.rev = newer.rev
        self.full = self.full or newer.full
        self.pods |= newer.pods
        self.bins = self.bins or newer.bins
        self.bin_names |= newer.bin_names
        self.bins_unnamed = self.bins_unnamed or newer.bins_unnamed
        self.volumes = self.volumes or newer.volumes
        self.daemonsets = self.daemonsets or newer.daemonsets
        self.other = self.other or newer.other
        self.ticks += newer.ticks
