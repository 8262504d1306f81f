"""Typed client over the FakeAPIServer — the controller-runtime client
analog.

Controllers act on the cluster EXCLUSIVELY through this client (reference
cmd/controller/main.go:47-53 hands every core controller the manager's
client); nothing typed crosses the seam — every call serializes through
apis/serde to the wire dicts the apiserver stores, so the protocol
boundary is real (a non-Python agent could speak it).

Write verbs mirror the reference's usage:

- ``create_*`` / ``delete_*`` / ``update_*`` (optimistic concurrency on
  update — retry on ConflictError like controller-runtime does)
- ``patch_*`` merge-patches named spec fields (status updates)
- ``bind_pod`` (pods/binding) and ``evict_pod`` (pods/eviction, PDB
  enforced server-side)
- NodeClaims are created WITH the termination finalizer: a delete only
  stamps deletionTimestamp and the termination controller later clears
  the finalizer — the reference's NodeClaim lifecycle contract.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..apis import serde
from ..apis.objects import (
    Lease, Node, NodeClaim, NodePool, PersistentVolumeClaim, Pod,
    PodDisruptionBudget, StorageClass,
)
from .apiserver import BulkOp, FakeAPIServer, NotFoundError, Watch

TERMINATION_FINALIZER = "karpenter.tpu/termination"


class KubeClient:
    def __init__(self, server: FakeAPIServer):
        self.server = server

    # ---- pods --------------------------------------------------------------

    def create_pod(self, pod: Pod) -> None:
        self.server.create("pods", serde.pod_to_dict(pod))

    def create_pods(self, pods: Sequence[Pod]) -> List[Optional[Exception]]:
        """Batched create through the bulk verb: one lock acquisition,
        one admission sweep, per-pod events. Returns a per-pod slot —
        None on success, the APIError on a captured failure."""
        res = self.server.bulk([("create", "pods", serde.pod_to_dict(p))
                                for p in pods])
        return [r if isinstance(r, Exception) else None for r in res]

    def delete_pods(self, names: Sequence[str]) -> int:
        """Batched delete (bulk verb); NotFound slots (raced teardowns)
        are ignored. Returns how many deletes landed."""
        res = self.server.bulk([("delete", "pods", n) for n in names])
        return sum(1 for r in res if not isinstance(r, Exception))

    def bind_pods(self, pairs: Sequence[Tuple[str, str]]) -> List[bool]:
        """Batched pods/binding: one lock acquisition and one watch
        flush for the whole list. Per-pair verdicts — a bind that raced
        an eviction/delete (Conflict/NotFound) reports False instead of
        failing the batch."""
        res = self.server.bulk([("bind", p, n) for p, n in pairs])
        return [not isinstance(r, Exception) for r in res]

    def get_pod(self, name: str) -> Pod:
        return serde.pod_from_dict(self.server.get("pods", name)["spec"])

    def list_pods(self) -> List[Pod]:
        items, _ = self.server.list("pods")
        return [serde.pod_from_dict(o["spec"]) for o in items]

    def bind_pod(self, name: str, node_name: str) -> None:
        self.server.bind(name, node_name)

    def evict_pod(self, name: str, force: bool = False) -> None:
        self.server.evict(name, force=force)

    def delete_pod(self, name: str) -> None:
        self.server.delete("pods", name)

    # ---- nodes -------------------------------------------------------------

    def create_node(self, node: Node) -> None:
        self.server.create("nodes", serde.node_to_dict(node))

    def get_node(self, name: str) -> Node:
        return serde.node_from_dict(self.server.get("nodes", name)["spec"])

    def list_nodes(self) -> List[Node]:
        items, _ = self.server.list("nodes")
        return [serde.node_from_dict(o["spec"]) for o in items]

    def patch_node(self, name: str, **spec_fields) -> None:
        self.server.patch("nodes", name, spec_fields)

    def taint_node(self, name: str, taint) -> bool:
        """Add a taint if absent; returns True when it was added."""
        obj = self.server.get("nodes", name)
        taints = obj["spec"].get("taints", [])
        if any(t["key"] == taint.key for t in taints):
            return False
        taints = taints + [serde._taint_to_dict(taint)]
        self.server.patch("nodes", name, {"taints": taints})
        return True

    def delete_node(self, name: str) -> None:
        self.server.delete("nodes", name)

    # ---- nodeclaims --------------------------------------------------------

    def create_nodeclaim(self, claim: NodeClaim) -> None:
        self.server.create("nodeclaims", serde.nodeclaim_to_dict(claim),
                           finalizers=(TERMINATION_FINALIZER,))

    @staticmethod
    def claim_from_envelope(obj: dict) -> NodeClaim:
        """Typed claim from a wire envelope, with the API-level deletion
        stamp overlaid: the delete verb marks metadata.deletionTimestamp
        (the spec is untouched), and every consumer truth-tests
        claim.deletion_timestamp — so ALL read paths must overlay it."""
        c = serde.nodeclaim_from_dict(obj["spec"])
        meta_ts = obj["metadata"]["deletionTimestamp"]
        if meta_ts is not None and not c.deletion_timestamp:
            c.deletion_timestamp = meta_ts
        return c

    def get_nodeclaim(self, name: str) -> NodeClaim:
        return self.claim_from_envelope(self.server.get("nodeclaims", name))

    def list_nodeclaims(self) -> List[NodeClaim]:
        items, _ = self.server.list("nodeclaims")
        return [self.claim_from_envelope(o) for o in items]

    # the status-ish fields a controller OWNS when it writes launch
    # results / phase transitions back (the reference's status().Update
    # contract). Spec fields (requirements, nodePool, taints, ...) and
    # lifecycle metadata (deletionTimestamp, finalizers) are deliberately
    # NOT here: patching them from a stale typed claim would last-writer-
    # wins another controller's write (e.g. clear a concurrent delete's
    # deletionTimestamp). annotations/labels ARE here (launch stamps the
    # nodeclass drift hashes); distinct controllers own distinct KEYS,
    # and the server's RFC 7386 merge keeps per-key writes from
    # clobbering siblings.
    _CLAIM_STATUS_FIELDS = (
        "phase", "providerID", "internalIP", "instanceType", "zone",
        "capacityType", "imageID", "capacity", "allocatable", "labels",
        "annotations", "launchedAt", "registeredAt", "initializedAt",
    )

    def update_nodeclaim(self, claim: NodeClaim) -> None:
        """Status write-back (launch results, phase transitions): merge
        ONLY the caller-owned status fields over the stored object. Patch
        semantics — no RV precondition — because exactly one controller
        owns each status field; restricting the patch to those fields is
        what makes that contract safe under concurrency."""
        full = serde.nodeclaim_to_dict(claim)
        self.server.patch("nodeclaims", claim.name,
                          {k: full[k] for k in self._CLAIM_STATUS_FIELDS})

    def delete_nodeclaim(self, name: str, now: Optional[float] = None) -> None:
        """The k8s delete that STARTS the finalizer flow: stamps
        deletionTimestamp; the termination controller drains, deletes the
        instance, then clears the finalizer to remove the object."""
        self.server.delete("nodeclaims", name, now=now)

    def remove_nodeclaim_finalizer(self, name: str) -> None:
        """Termination complete: drop the finalizer (the object is removed
        if it was deleting)."""
        try:
            self.server.patch("nodeclaims", name, finalizers=())
        except NotFoundError:
            pass

    def delete_nodeclaim_now(self, name: str) -> None:
        """Hard delete bypassing the finalizer — rollback of a claim whose
        instance never launched."""
        self.server.delete("nodeclaims", name, force=True)

    def claims_by_provider_id(self, provider_id: str) -> List[NodeClaim]:
        return [self.claim_from_envelope(o)
                for o in self.server.get_by_index(
                    "nodeclaims", "providerID", provider_id)]

    # ---- nodepools / nodeclasses ------------------------------------------

    def create_nodepool(self, pool: NodePool) -> None:
        self.server.create("nodepools", serde.nodepool_to_dict(pool))

    def list_nodepools(self) -> List[NodePool]:
        items, _ = self.server.list("nodepools")
        # controller-owned live usage rides the envelope status sub-map
        return [serde.nodepool_apply_status(
                    serde.nodepool_from_dict(o["spec"]), o.get("status"))
                for o in items]

    def update_nodepool(self, pool: NodePool) -> None:
        self.server.patch("nodepools", pool.name, serde.nodepool_to_dict(pool))

    def delete_nodepool(self, name: str) -> None:
        self.server.delete("nodepools", name)

    def create_nodeclass(self, nc) -> None:
        self.server.create("nodeclasses", serde.nodeclass_to_dict(nc))

    def list_nodeclasses(self) -> List:
        items, _ = self.server.list("nodeclasses")
        return [serde.nodeclass_from_dict(o["spec"]) for o in items]

    def update_nodeclass(self, nc) -> None:
        self.server.patch("nodeclasses", nc.name, serde.nodeclass_to_dict(nc))

    # ---- volumes / pdbs / leases ------------------------------------------

    def create_pvc(self, pvc: PersistentVolumeClaim) -> None:
        self.server.create("pvcs", serde.pvc_to_dict(pvc))

    def patch_pvc(self, name: str, **spec_fields) -> None:
        self.server.patch("pvcs", name, spec_fields)

    def create_storage_class(self, sc: StorageClass) -> None:
        self.server.create("storageclasses", serde.storage_class_to_dict(sc))

    def create_pdb(self, pdb: PodDisruptionBudget) -> None:
        self.server.create("pdbs", serde.pdb_to_dict(pdb))

    def delete_pdb(self, name: str) -> None:
        self.server.delete("pdbs", name)

    def create_lease(self, lease: Lease) -> None:
        self.server.create("leases", serde.lease_to_dict(lease))

    def delete_lease(self, name: str) -> None:
        try:
            self.server.delete("leases", name)
        except NotFoundError:
            pass

    # ---- raw protocol ------------------------------------------------------

    def list_raw(self, kind: str) -> Tuple[List[dict], int]:
        return self.server.list(kind)

    def bulk(self, ops: Sequence[BulkOp]) -> List:
        """Raw batched apply (apiserver.bulk): many writes, one lock
        acquisition + admission sweep + watch flush per kind touched;
        per-op results/errors aligned with ``ops``."""
        return self.server.bulk(ops)

    def watch(self, kind: str, resource_version: int = 0) -> Watch:
        return self.server.watch(kind, resource_version)


def install_default_indexes(server: FakeAPIServer) -> None:
    """The manager's field indexes (reference operator.go:180-186 indexes
    NodeClaims on status.providerID for instance→claim lookups).
    Idempotent: double wiring (cli pre-serve + Operator) is a no-op."""
    if getattr(server, "_kpat_indexes_installed", False):
        return
    server._kpat_indexes_installed = True
    server.add_index("nodeclaims", "providerID",
                     lambda spec: spec.get("providerID"))
    server.add_index("pods", "nodeName", lambda spec: spec.get("nodeName"))


def install_admission(server: FakeAPIServer) -> None:
    """Wire the admission chain at the API boundary (reference
    pkg/webhooks/webhooks.go): defaults first, then SCHEMA validation
    (apis/schema.py — the machine-readable CRD contract, patterns/enums/
    cross-field rules), then the semantic webhooks. Nothing structurally
    or semantically invalid crosses the seam. Idempotent: double wiring
    (cli pre-serve + Operator) must not chain validators twice."""
    if getattr(server, "_kpat_admission_installed", False):
        return
    server._kpat_admission_installed = True
    from .. import webhooks
    from ..apis import schema

    def _np_default(spec: dict) -> dict:
        # schema-check BEFORE typed parsing: malformed input gets the
        # precise structural diagnostic, not a parse crash
        errs = schema.validate("nodepools", spec)
        if errs:
            from .apiserver import InvalidObjectError
            raise InvalidObjectError("nodepools",
                                     spec.get("name", "?"), errs)
        pool = serde.nodepool_from_dict(spec)
        webhooks.default_node_pool(pool)
        return serde.nodepool_to_dict(pool)

    def _np_validate(spec: dict) -> List[str]:
        # structural validation already ran in _np_default (before typed
        # parsing) and the spec only round-tripped serde since — running
        # the schema pass again here would double the admission cost
        return webhooks.validate_node_pool(serde.nodepool_from_dict(spec))

    def _nc_validate(spec: dict) -> List[str]:
        errs = schema.validate("nodeclasses", spec)
        if errs:
            return errs
        return webhooks.validate_node_class(serde.nodeclass_from_dict(spec))

    def _claim_validate(spec: dict) -> List[str]:
        return schema.validate("nodeclaims", spec)

    def _pdb_validate(spec: dict) -> List[str]:
        return webhooks.validate_pdb(serde.pdb_from_dict(spec))

    server.register_admission("nodepools", validate=_np_validate,
                              default=_np_default)
    server.register_admission("nodeclasses", validate=_nc_validate)
    server.register_admission("nodeclaims", validate=_claim_validate)
    server.register_admission("pdbs", validate=_pdb_validate)
