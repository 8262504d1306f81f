"""Wire (de)serialization for the API objects.

The solver sidecar (parallel/sidecar.py) ships Pods/NodePools/cluster
state across a process boundary the way the reference's controller ships
kube objects over the API server watch stream (SURVEY §2.3 communication
backend). JSON keeps the wire format language-neutral: a non-Python
controller can build these payloads directly.

Round-trip contract: ``pod_from_dict(pod_to_dict(p))`` produces a Pod that
schedules identically (same scheduling signature), and likewise for every
other object here.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np

from .objects import (
    DisruptionBudget, KubeletSpec, NodePool, NodePoolDisruption,
    PersistentVolumeClaim, Pod, PodAffinityTerm, PreferredRequirement,
    StorageClass, Taint, TaintEffect, Toleration, TopologySpreadConstraint,
)
from .requirements import Operator, Requirement

# ---- requirements ----------------------------------------------------------


def requirement_to_dict(r: Requirement) -> Dict:
    out = {"key": r.key, "operator": r.operator.value,
           "values": list(r.values)}
    if r.min_values is not None:
        out["minValues"] = r.min_values
    return out


def requirement_from_dict(d: Mapping) -> Requirement:
    return Requirement(key=d["key"], operator=Operator(d["operator"]),
                       values=tuple(d.get("values", ())),
                       min_values=d.get("minValues"))


# ---- pod -------------------------------------------------------------------


def pod_to_dict(p: Pod) -> Dict:
    return {
        "name": p.name,
        "namespace": p.namespace,
        "labels": dict(p.labels),
        "annotations": dict(p.annotations),
        "requests": {k: str(v) for k, v in p.requests.items()},
        "nodeSelector": dict(p.node_selector),
        "requiredAffinity": [requirement_to_dict(r) for r in p.required_affinity],
        "preferredAffinity": [
            {"requirement": requirement_to_dict(pr.requirement),
             "weight": pr.weight} for pr in p.preferred_affinity],
        "tolerations": [
            {"key": t.key, "operator": t.operator, "value": t.value,
             "effect": t.effect.value if t.effect is not None else None}
            for t in p.tolerations],
        "topologySpread": [
            {"maxSkew": c.max_skew, "topologyKey": c.topology_key,
             "whenUnsatisfiable": c.when_unsatisfiable,
             "labelSelector": [list(kv) for kv in c.label_selector]}
            for c in p.topology_spread],
        "podAffinity": [
            {"topologyKey": t.topology_key,
             "labelSelector": [list(kv) for kv in t.label_selector],
             "anti": t.anti} for t in p.pod_affinity],
        "volumeClaims": list(p.volume_claims),
        "nodeName": p.node_name,
        "owner": p.owner,
        "isDaemonset": p.is_daemonset,
        "priority": p.priority,
        "deletionTimestamp": p.deletion_timestamp,
    }


def pod_from_dict(d: Mapping) -> Pod:
    return Pod(
        name=d["name"],
        namespace=d.get("namespace", "default"),
        labels=dict(d.get("labels", {})),
        annotations=dict(d.get("annotations", {})),
        requests=dict(d.get("requests", {})),
        node_selector=dict(d.get("nodeSelector", {})),
        required_affinity=[requirement_from_dict(r)
                           for r in d.get("requiredAffinity", ())],
        preferred_affinity=[
            PreferredRequirement(
                requirement=requirement_from_dict(pr["requirement"]),
                weight=pr.get("weight", 1))
            for pr in d.get("preferredAffinity", ())],
        tolerations=[
            Toleration(key=t.get("key", ""), operator=t.get("operator", "Equal"),
                       value=t.get("value", ""),
                       effect=(TaintEffect(t["effect"])
                               if t.get("effect") else None))
            for t in d.get("tolerations", ())],
        topology_spread=[
            TopologySpreadConstraint(
                max_skew=c["maxSkew"], topology_key=c["topologyKey"],
                when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
                label_selector=tuple(tuple(kv) for kv in c.get("labelSelector", ())))
            for c in d.get("topologySpread", ())],
        pod_affinity=[
            PodAffinityTerm(
                topology_key=t["topologyKey"],
                label_selector=tuple(tuple(kv) for kv in t.get("labelSelector", ())),
                anti=t.get("anti", False))
            for t in d.get("podAffinity", ())],
        volume_claims=list(d.get("volumeClaims", ())),
        node_name=d.get("nodeName"),
        owner=d.get("owner"),
        is_daemonset=d.get("isDaemonset", False),
        priority=d.get("priority", 0),
        deletion_timestamp=d.get("deletionTimestamp"),
    )


# ---- nodepool --------------------------------------------------------------


def nodepool_to_dict(p: NodePool) -> Dict:
    return {
        "name": p.name,
        "weight": p.weight,
        "labels": dict(p.labels),
        "annotations": dict(p.annotations),
        "requirements": [requirement_to_dict(r) for r in p.requirements],
        "taints": [{"key": t.key, "value": t.value, "effect": t.effect.value}
                   for t in p.taints],
        "startupTaints": [{"key": t.key, "value": t.value,
                           "effect": t.effect.value}
                          for t in p.startup_taints],
        "limits": {k: str(v) for k, v in p.limits.items()},
        "disruption": {
            "consolidationPolicy": p.disruption.consolidation_policy,
            "consolidateAfter": p.disruption.consolidate_after,
            "expireAfter": p.disruption.expire_after,
            "budgets": [
                {"nodes": b.nodes, "schedule": b.schedule,
                 "duration": b.duration, "reasons": list(b.reasons)}
                for b in p.disruption.budgets],
        },
        "nodeClassRef": p.node_class_ref,
        "kubelet": ({"maxPods": p.kubelet.max_pods,
                     "clusterDNS": p.kubelet.cluster_dns}
                    if p.kubelet is not None else None),
        # NOTE: status_resources deliberately does NOT ride the spec —
        # it is controller-owned live usage (the reference NodePool's
        # status.resources) and lives in the envelope's status sub-map
        # (nodepool_status_to_dict), so a `kpctl get -o yaml | kpctl
        # apply` round-trip can never re-submit stale controller status
        # as user intent.
    }


def nodepool_status_to_dict(p: NodePool) -> Dict:
    """The controller-owned status sub-map of a NodePool envelope —
    the reference's spec/status split. User applies never carry it; the
    apiserver preserves the stored status across spec updates."""
    return {"resources": dict(p.status_resources)}


def nodepool_apply_status(p: NodePool, status: Optional[Mapping]) -> NodePool:
    """Hydrate a deserialized NodePool with its envelope status (the
    inverse of nodepool_status_to_dict); tolerates a missing map."""
    if status:
        p.status_resources = dict(status.get("resources", {}))
    return p


def nodepool_from_dict(d: Mapping) -> NodePool:
    dis = d.get("disruption", {})
    return NodePool(
        name=d["name"],
        weight=d.get("weight", 0),
        labels=dict(d.get("labels", {})),
        annotations=dict(d.get("annotations", {})),
        requirements=[requirement_from_dict(r)
                      for r in d.get("requirements", ())],
        taints=[Taint(key=t["key"], value=t.get("value", ""),
                      effect=TaintEffect(t.get("effect", "NoSchedule")))
                for t in d.get("taints", ())],
        startup_taints=[Taint(key=t["key"], value=t.get("value", ""),
                              effect=TaintEffect(t.get("effect", "NoSchedule")))
                        for t in d.get("startupTaints", ())],
        limits=dict(d.get("limits", {})),
        disruption=NodePoolDisruption(
            consolidation_policy=dis.get("consolidationPolicy",
                                         "WhenUnderutilized"),
            consolidate_after=dis.get("consolidateAfter"),
            expire_after=dis.get("expireAfter"),
            budgets=[DisruptionBudget(
                nodes=b.get("nodes", "10%"), schedule=b.get("schedule"),
                duration=b.get("duration"),
                reasons=tuple(b.get("reasons", ())))
                for b in dis.get("budgets", [{}])]),
        node_class_ref=d.get("nodeClassRef", "default"),
        kubelet=(KubeletSpec(max_pods=d["kubelet"].get("maxPods"),
                             cluster_dns=d["kubelet"].get("clusterDNS"))
                 if d.get("kubelet") else None),
        # legacy payloads carried status in the spec; accept it on read
        # (admission normalization strips it on the next write)
        status_resources=dict(d.get("statusResources", {})),
    )


# ---- volumes ---------------------------------------------------------------


def pvc_to_dict(c: PersistentVolumeClaim) -> Dict:
    return {"name": c.name, "storageClass": c.storage_class,
            "boundZone": c.bound_zone}


def pvc_from_dict(d: Mapping) -> PersistentVolumeClaim:
    return PersistentVolumeClaim(name=d["name"],
                                 storage_class=d.get("storageClass", ""),
                                 bound_zone=d.get("boundZone"))


def storage_class_to_dict(s: StorageClass) -> Dict:
    return {"name": s.name, "zones": list(s.zones),
            "bindingMode": s.binding_mode, "provisioner": s.provisioner}


def storage_class_from_dict(d: Mapping) -> StorageClass:
    return StorageClass(name=d["name"], zones=tuple(d.get("zones", ())),
                        binding_mode=d.get("bindingMode",
                                           "WaitForFirstConsumer"),
                        provisioner=d.get("provisioner", "ebs.csi.aws.com"))


# ---- solver-side objects ---------------------------------------------------


def existing_bin_to_dict(b) -> Dict:
    return {
        "name": b.name, "nodePool": b.node_pool,
        "instanceType": b.instance_type, "zone": b.zone,
        "capacityType": b.capacity_type,
        "used": np.asarray(b.used, dtype=float).tolist(),
        # per-element null = axis the node did not report (NaN sentinel);
        # NaN itself is not representable in strict RFC 8259 JSON and the
        # wire must stay cross-language
        "allocOverride": ([None if np.isnan(x) else x
                           for x in np.asarray(b.alloc_override, dtype=float)]
                          if b.alloc_override is not None else None),
        "labels": dict(b.labels),
    }


def existing_bin_from_dict(d: Mapping):
    from ..solver.problem import ExistingBin
    return ExistingBin(
        name=d["name"], node_pool=d["nodePool"],
        instance_type=d["instanceType"], zone=d["zone"],
        capacity_type=d["capacityType"],
        used=np.asarray(d["used"], dtype=np.float32),
        alloc_override=(np.asarray(
            [np.nan if x is None else x for x in d["allocOverride"]],
            dtype=np.float32)
            if d.get("allocOverride") is not None else None),
        labels=dict(d.get("labels", {})),
    )


def plan_to_dict(plan) -> Dict:
    return {
        "newNodes": [
            {"nodePool": n.node_pool, "instanceType": n.instance_type,
             "zone": n.zone, "capacityType": n.capacity_type,
             "pricePerHour": n.price_per_hour, "pods": list(n.pods),
             "feasibleTypes": list(n.feasible_types),
             "feasibleZones": list(n.feasible_zones),
             "feasibleCapacityTypes": list(n.feasible_capacity_types),
             "extraLabels": dict(n.extra_labels)}
            for n in plan.new_nodes],
        "existingAssignments": {k: list(v)
                                for k, v in plan.existing_assignments.items()},
        "unschedulable": dict(plan.unschedulable),
        "newNodeCost": plan.new_node_cost,
        "solveSeconds": plan.solve_seconds,
        "deviceSeconds": plan.device_seconds,
        "warnings": list(plan.warnings),
        # degradation provenance crosses the wire so a sidecar client's
        # controller observes degraded mode exactly like an in-process one
        "degraded": plan.degraded,
        "degradedReason": plan.degraded_reason,
        "solverPath": plan.solver_path,
        "waves": plan.waves,
        "deviceRetries": plan.device_retries,
        # per-stage wall-clock of the solve (solver/pipeline.py STAGES)
        # and whether the overlapped path produced it — a sidecar client
        # sees the same pipelining evidence as an in-process controller
        "stageMs": {k: round(float(v), 3)
                    for k, v in plan.stage_ms.items()},
        "pipelined": plan.pipelined,
        # the mesh that produced this plan (1 = single-device) and its
        # split's load balance: a RemoteSolver caller sees whether the
        # sidecar's mesh engaged — and how evenly — exactly like an
        # in-process controller (docs/reference/sharding.md)
        "meshDevices": plan.mesh_devices,
        "shardImbalance": round(float(plan.shard_imbalance), 4),
    }


# wire keys that carry timing/provenance rather than plan CONTENT: the
# byte-identity surface parity checks (mesh-vs-single-device,
# pipelined-vs-sequential, bench parity rows) compare plans with these
# stripped. ONE list — a new provenance field added to plan_to_dict
# joins it here, and every parity site stays in sync automatically.
# NOTE "warnings" stays IN the compared surface: both sides of every
# parity pair derive warnings from the same problem, so a path that
# drops or duplicates them is a real regression the parity must catch.
_PLAN_PROVENANCE_KEYS = ("solveSeconds", "deviceSeconds", "stageMs",
                         "pipelined", "deviceRetries", "meshDevices",
                         "shardImbalance")


def plan_semantic_dict(plan) -> Dict:
    """``plan_to_dict`` minus timing/provenance — the canonical content
    two solves of the same problem must agree on byte-for-byte."""
    d = plan_to_dict(plan)
    for k in _PLAN_PROVENANCE_KEYS:
        d.pop(k, None)
    return d


def plan_from_dict(d: Mapping):
    from ..solver.solve import NodePlan, PlannedNode
    return NodePlan(
        new_nodes=[
            PlannedNode(
                node_pool=n["nodePool"], instance_type=n["instanceType"],
                zone=n["zone"], capacity_type=n["capacityType"],
                price_per_hour=n["pricePerHour"], pods=list(n["pods"]),
                feasible_types=list(n.get("feasibleTypes", ())),
                feasible_zones=list(n.get("feasibleZones", ())),
                feasible_capacity_types=list(n.get("feasibleCapacityTypes", ())),
                extra_labels=dict(n.get("extraLabels", {})))
            for n in d.get("newNodes", ())],
        existing_assignments={k: list(v) for k, v in
                              d.get("existingAssignments", {}).items()},
        unschedulable=dict(d.get("unschedulable", {})),
        new_node_cost=d.get("newNodeCost", 0.0),
        solve_seconds=d.get("solveSeconds", 0.0),
        device_seconds=d.get("deviceSeconds", 0.0),
        warnings=list(d.get("warnings", ())),
        degraded=bool(d.get("degraded", False)),
        degraded_reason=d.get("degradedReason", ""),
        solver_path=d.get("solverPath", "device"),
        waves=int(d.get("waves", 1)),
        device_retries=int(d.get("deviceRetries", 0)),
        stage_ms={k: float(v) for k, v in d.get("stageMs", {}).items()},
        pipelined=bool(d.get("pipelined", False)),
        mesh_devices=int(d.get("meshDevices", 1)),
        shard_imbalance=float(d.get("shardImbalance", 0.0)),
    )

# ---- node / nodeclaim / nodeclass / pdb / lease (apiserver wire) -----------
# These ride the kube seam (kube/apiserver.py): everything the controllers
# read or write crosses the watch/list protocol as these dicts, the way the
# reference's objects cross the apiserver (SURVEY §2.1 #23 API types).


def _taint_to_dict(t: Taint) -> Dict:
    return {"key": t.key, "value": t.value, "effect": t.effect.value}


def _taint_from_dict(d: Mapping) -> Taint:
    return Taint(key=d["key"], value=d.get("value", ""),
                 effect=TaintEffect(d.get("effect", "NoSchedule")))


def node_to_dict(n) -> Dict:
    return {
        "name": n.name,
        "providerID": n.provider_id,
        "internalIP": n.internal_ip,
        "labels": dict(n.labels),
        "annotations": dict(n.annotations),
        "taints": [_taint_to_dict(t) for t in n.taints],
        "capacity": dict(n.capacity),
        "allocatable": dict(n.allocatable),
        "ready": n.ready,
        "createdAt": n.created_at,
        "nodePool": n.node_pool,
        "nodeClaim": n.node_claim,
    }


def node_from_dict(d: Mapping):
    from .objects import Node
    return Node(
        name=d["name"], provider_id=d.get("providerID", ""),
        internal_ip=d.get("internalIP"),
        labels=dict(d.get("labels", {})),
        annotations=dict(d.get("annotations", {})),
        taints=[_taint_from_dict(t) for t in d.get("taints", ())],
        capacity=dict(d.get("capacity", {})),
        allocatable=dict(d.get("allocatable", {})),
        ready=d.get("ready", False),
        created_at=d.get("createdAt", 0.0),
        node_pool=d.get("nodePool"),
        node_claim=d.get("nodeClaim"),
    )


def nodeclaim_to_dict(c) -> Dict:
    return {
        "name": c.name,
        "nodePool": c.node_pool,
        "requirements": [requirement_to_dict(r) for r in c.requirements],
        "resourceRequests": dict(c.resource_requests),
        "labels": dict(c.labels),
        "annotations": dict(c.annotations),
        "taints": [_taint_to_dict(t) for t in c.taints],
        "nodeClassRef": c.node_class_ref,
        "phase": c.phase.value,
        "maxPods": c.max_pods,
        "clusterDNS": c.cluster_dns,
        "providerID": c.provider_id,
        "internalIP": c.internal_ip,
        "instanceType": c.instance_type,
        "zone": c.zone,
        "capacityType": c.capacity_type,
        "imageID": c.image_id,
        "capacity": dict(c.capacity),
        "allocatable": dict(c.allocatable),
        "createdAt": c.created_at,
        "launchedAt": c.launched_at,
        "registeredAt": c.registered_at,
        "initializedAt": c.initialized_at,
        "deletionTimestamp": c.deletion_timestamp,
    }


def nodeclaim_from_dict(d: Mapping):
    from .objects import NodeClaim, NodeClaimPhase
    return NodeClaim(
        name=d["name"], node_pool=d.get("nodePool", ""),
        requirements=[requirement_from_dict(r)
                      for r in d.get("requirements", ())],
        resource_requests=dict(d.get("resourceRequests", {})),
        labels=dict(d.get("labels", {})),
        annotations=dict(d.get("annotations", {})),
        taints=[_taint_from_dict(t) for t in d.get("taints", ())],
        node_class_ref=d.get("nodeClassRef", "default"),
        phase=NodeClaimPhase(d.get("phase", "Pending")),
        max_pods=d.get("maxPods"),
        cluster_dns=d.get("clusterDNS"),
        provider_id=d.get("providerID"),
        internal_ip=d.get("internalIP"),
        instance_type=d.get("instanceType"),
        zone=d.get("zone"),
        capacity_type=d.get("capacityType"),
        image_id=d.get("imageID"),
        capacity=dict(d.get("capacity", {})),
        allocatable=dict(d.get("allocatable", {})),
        created_at=d.get("createdAt", 0.0),
        launched_at=d.get("launchedAt"),
        registered_at=d.get("registeredAt"),
        initialized_at=d.get("initializedAt"),
        deletion_timestamp=d.get("deletionTimestamp"),
    )


def _selector_term_to_dict(t) -> Dict:
    return {"tags": [list(kv) for kv in t.tags], "id": t.id, "name": t.name}


def _selector_term_from_dict(d: Mapping):
    from .objects import NodeClassSelectorTerm
    return NodeClassSelectorTerm(
        tags=tuple(tuple(kv) for kv in d.get("tags", ())),
        id=d.get("id"), name=d.get("name"))


def nodeclass_to_dict(nc) -> Dict:
    return {
        "name": nc.name,
        "amiFamily": nc.ami_family,
        "subnetSelectorTerms": [_selector_term_to_dict(t)
                                for t in nc.subnet_selector_terms],
        "securityGroupSelectorTerms": [_selector_term_to_dict(t)
                                       for t in nc.security_group_selector_terms],
        "amiSelectorTerms": [_selector_term_to_dict(t)
                             for t in nc.ami_selector_terms],
        "userData": nc.user_data,
        "role": nc.role,
        "instanceProfile": nc.instance_profile,
        "tags": dict(nc.tags),
        "blockDeviceMappings": [dict(b) for b in nc.block_device_mappings],
        "instanceStorePolicy": nc.instance_store_policy,
        "metadataOptions": {
            "httpEndpoint": nc.metadata_options.http_endpoint,
            "httpProtocolIPv6": nc.metadata_options.http_protocol_ipv6,
            "httpPutResponseHopLimit": nc.metadata_options.http_put_response_hop_limit,
            "httpTokens": nc.metadata_options.http_tokens,
        },
        "detailedMonitoring": nc.detailed_monitoring,
        "associatePublicIP": nc.associate_public_ip,
        "annotations": dict(nc.annotations),
        "statusSubnets": [dict(s) for s in nc.status_subnets],
        "statusSecurityGroups": [dict(s) for s in nc.status_security_groups],
        "statusAMIs": [dict(s) for s in nc.status_amis],
        "statusInstanceProfile": nc.status_instance_profile,
        "statusConditions": dict(nc.status_conditions),
    }


def nodeclass_from_dict(d: Mapping):
    from .objects import MetadataOptions, NodeClass
    mo = d.get("metadataOptions") or {}
    return NodeClass(
        name=d["name"],
        ami_family=d.get("amiFamily", "AL2023"),
        subnet_selector_terms=[_selector_term_from_dict(t)
                               for t in d.get("subnetSelectorTerms", ())],
        security_group_selector_terms=[
            _selector_term_from_dict(t)
            for t in d.get("securityGroupSelectorTerms", ())],
        ami_selector_terms=[_selector_term_from_dict(t)
                            for t in d.get("amiSelectorTerms", ())],
        user_data=d.get("userData"),
        role=d.get("role"),
        instance_profile=d.get("instanceProfile"),
        tags=dict(d.get("tags", {})),
        block_device_mappings=[dict(b)
                               for b in d.get("blockDeviceMappings", ())],
        instance_store_policy=d.get("instanceStorePolicy"),
        metadata_options=MetadataOptions(
            http_endpoint=mo.get("httpEndpoint", "enabled"),
            http_protocol_ipv6=mo.get("httpProtocolIPv6", "disabled"),
            http_put_response_hop_limit=mo.get("httpPutResponseHopLimit", 2),
            http_tokens=mo.get("httpTokens", "required")),
        detailed_monitoring=d.get("detailedMonitoring", False),
        associate_public_ip=d.get("associatePublicIP"),
        annotations=dict(d.get("annotations", {})),
        status_subnets=[dict(s) for s in d.get("statusSubnets", ())],
        status_security_groups=[dict(s)
                                for s in d.get("statusSecurityGroups", ())],
        status_amis=[dict(s) for s in d.get("statusAMIs", ())],
        status_instance_profile=d.get("statusInstanceProfile"),
        status_conditions=dict(d.get("statusConditions", {})),
    )


def pdb_to_dict(p) -> Dict:
    return {
        "name": p.name,
        "namespace": p.namespace,
        "labelSelector": dict(p.label_selector),
        "maxUnavailable": p.max_unavailable,
        "minAvailable": p.min_available,
    }


def pdb_from_dict(d: Mapping):
    from .objects import PodDisruptionBudget
    return PodDisruptionBudget(
        name=d["name"], namespace=d.get("namespace", "default"),
        label_selector=dict(d.get("labelSelector", {})),
        max_unavailable=d.get("maxUnavailable"),
        min_available=d.get("minAvailable"))


def lease_to_dict(l) -> Dict:
    return {"name": l.name, "ownerNode": l.owner_node,
            "createdAt": l.created_at}


def lease_from_dict(d: Mapping):
    from .objects import Lease
    return Lease(name=d["name"], owner_node=d.get("ownerNode"),
                 created_at=d.get("createdAt", 0.0))
