"""NodeClaim tagging controller.

Mirror of the reference's post-registration instance tagger (reference
pkg/controllers/nodeclaim/tagging/controller.go:57-110): once a NodeClaim's
node registers, its backing instance is tagged with ``Name`` (the node
name) and ``karpenter.sh/nodeclaim`` (the claim name). Already-present tags
are never overwritten (controller.go:99-104), success is recorded in the
``karpenter.sh/instance-tagged`` annotation so a claim is only processed
once, and a vanished instance is skipped without error (the GC controller
owns that case).
"""

from __future__ import annotations

from typing import Optional

from ..apis import wellknown as wk
from ..cloud.fake import parse_instance_id
from ..errors import NotFoundError
from ..events import Recorder
from ..state.cluster import ClusterState
from ..utils.clock import Clock


class TaggingController:
    def __init__(self, cluster: ClusterState, cloud, recorder: Optional[Recorder] = None,
                 clock: Optional[Clock] = None):
        self.cluster = cluster
        self.cloud = cloud
        self.clock = clock or Clock()
        self.recorder = recorder or Recorder(self.clock)

    def _taggable(self, claim) -> bool:
        """Registered, live, carries a provider id, not yet tagged
        (controller.go isTaggable)."""
        return (claim.provider_id is not None
                and claim.registered_at is not None
                and claim.deletion_timestamp is None
                and claim.annotations.get(wk.ANNOTATION_INSTANCE_TAGGED) != "true")

    def reconcile(self) -> int:
        tagged = 0
        for claim in list(self.cluster.claims.values()):
            if not self._taggable(claim):
                continue
            try:
                iid = parse_instance_id(claim.provider_id)
            except ValueError:
                # malformed provider id: do not retry until it changes
                # (controller.go:63-67)
                continue
            node = self.cluster.node_for_claim(claim.name)
            tags = {wk.TAG_NAME: node.name if node is not None else claim.name,
                    wk.TAG_NODECLAIM: claim.name}
            try:
                (inst,) = self.cloud.describe_instances([iid]) or (None,)
            except NotFoundError:
                inst = None
            if inst is None or inst.state == "terminated":
                continue  # GC owns vanished instances
            missing = {k: v for k, v in tags.items() if k not in inst.tags}
            if missing:
                try:
                    self.cloud.create_tags(iid, missing)
                except NotFoundError:
                    continue
            claim.annotations[wk.ANNOTATION_INSTANCE_TAGGED] = "true"
            tagged += 1
        return tagged
