"""AMI family strategies + AMI resolver.

Mirror of reference pkg/providers/amifamily: the strategy pattern over
AMI families (resolver.go:167-184 — AL2, AL2023, Bottlerocket, Ubuntu,
Windows, Custom), SSM-parameter default-AMI discovery (ami.go:136-181),
AMI→architecture compatibility mapping (ami.go:91-102), and per-AMI
launch-parameter resolution (resolver.go:122-165). User data rendering is
family-specific: shell/MIME for AL2, nodeadm YAML-ish for AL2023, TOML for
Bottlerocket — enough structure for drift hashing and tests; a real
bootstrap would extend the same hooks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..apis.objects import NodeClass
from ..cache.ttl import TTLCache
from ..cloud.fake import FakeCloud
from ..cloud.network import Image
from ..errors import NotFoundError
from ..utils.clock import Clock

AMI_TTL = 300.0  # 5 min


@dataclass
class ResolvedAMI:
    id: str
    name: str
    arch: str            # amd64 | arm64


@dataclass
class LaunchParameters:
    """Per-(AMI, arch, userdata) launch template parameterization
    (resolver.go:122-165 groups by {AMI, maxPods, EFA}); userdata varies
    with the kubelet cluster-DNS, so pools with different kubelet blocks
    resolve distinct parameter sets (and distinct launch templates via
    the content hash)."""

    ami: ResolvedAMI
    user_data: str
    arch: str


class AMIFamily:
    name = "Custom"
    _arch_alias = {"amd64": "x86_64", "arm64": "arm64"}
    # root/ephemeral device the family's AMIs mount (reference
    # amifamily/<family>.go EphemeralBlockDevice); None = unknown (Custom)
    ephemeral_block_device: Optional[str] = None

    def default_ami_ssm_parameters(self, k8s_version: str) -> Dict[str, str]:
        """arch -> SSM parameter path for the family's default AMI."""
        return {}

    def user_data(self, node_class: NodeClass, cluster_name: str,
                  cluster_endpoint: str,
                  cluster_dns: Optional[str] = None) -> str:
        # Custom AMIs own their full userdata, incl. DNS wiring
        return node_class.user_data or ""


class AL2(AMIFamily):
    name = "AL2"
    ephemeral_block_device = "/dev/xvda"

    def default_ami_ssm_parameters(self, k8s_version):
        base = "/aws/service/eks/optimized-ami/{v}/amazon-linux-2{suffix}/recommended/image_id"
        return {
            "amd64": base.format(v=k8s_version, suffix=""),
            "arm64": base.format(v=k8s_version, suffix="-arm64"),
        }

    def user_data(self, node_class, cluster_name, cluster_endpoint,
                  cluster_dns=None):
        custom = node_class.user_data or ""
        dns = f" --dns-cluster-ip '{cluster_dns}'" if cluster_dns else ""
        return (
            "MIME-Version: 1.0\n"
            f"{custom}\n"
            f"/etc/eks/bootstrap.sh {cluster_name} --apiserver-endpoint {cluster_endpoint}{dns}\n"
        )


class AL2023(AMIFamily):
    name = "AL2023"
    ephemeral_block_device = "/dev/xvda"

    def default_ami_ssm_parameters(self, k8s_version):
        base = "/aws/service/eks/optimized-ami/{v}/amazon-linux-2023/{arch}/standard/recommended/image_id"
        return {a: base.format(v=k8s_version, arch=self._arch_alias[a])
                for a in ("amd64", "arm64")}

    def user_data(self, node_class, cluster_name, cluster_endpoint,
                  cluster_dns=None):
        custom = node_class.user_data or ""
        dns = f"  clusterDNS: {cluster_dns}\n" if cluster_dns else ""
        return (
            "apiVersion: node.eks.aws/v1alpha1\nkind: NodeConfig\n"
            f"cluster:\n  name: {cluster_name}\n  apiServerEndpoint: {cluster_endpoint}\n"
            f"{dns}{custom}\n"
        )


class Bottlerocket(AMIFamily):
    name = "Bottlerocket"
    ephemeral_block_device = "/dev/xvdb"

    def default_ami_ssm_parameters(self, k8s_version):
        base = "/aws/service/bottlerocket/aws-k8s-{v}/{arch}/latest/image_id"
        return {a: base.format(v=k8s_version, arch=self._arch_alias[a])
                for a in ("amd64", "arm64")}

    def user_data(self, node_class, cluster_name, cluster_endpoint,
                  cluster_dns=None):
        custom = node_class.user_data or ""
        dns = f'cluster-dns-ip = "{cluster_dns}"\n' if cluster_dns else ""
        return (
            "[settings.kubernetes]\n"
            f'cluster-name = "{cluster_name}"\n'
            f'api-server = "{cluster_endpoint}"\n'
            f"{dns}{custom}\n"
        )


class Ubuntu(AMIFamily):
    name = "Ubuntu"
    ephemeral_block_device = "/dev/sda1"

    def default_ami_ssm_parameters(self, k8s_version):
        base = "/aws/service/canonical/ubuntu/eks/22.04/{v}/stable/current/{arch}/hvm/ebs-gp2/ami-id"
        return {a: base.format(v=k8s_version, arch=self._arch_alias[a])
                for a in ("amd64", "arm64")}

    def user_data(self, node_class, cluster_name, cluster_endpoint,
                  cluster_dns=None):
        return AL2().user_data(node_class, cluster_name, cluster_endpoint,
                               cluster_dns=cluster_dns)


class Windows(AMIFamily):
    name = "Windows"
    ephemeral_block_device = "/dev/sda1"

    def default_ami_ssm_parameters(self, k8s_version):
        return {"amd64":
                f"/aws/service/ami-windows-latest/Windows_Server-2022-English-Core-EKS_Optimized-{k8s_version}/image_id"}

    def user_data(self, node_class, cluster_name, cluster_endpoint,
                  cluster_dns=None):
        custom = node_class.user_data or ""
        dns = f" -DNSClusterIP '{cluster_dns}'" if cluster_dns else ""
        return (f"<powershell>\n{custom}\n"
                f"[EKS bootstrap {cluster_name}{dns}]\n</powershell>\n")


class Custom(AMIFamily):
    """No defaults: AMI selector terms are required; user data passes
    through verbatim (amifamily/custom.go)."""
    name = "Custom"


AMI_FAMILIES: Dict[str, AMIFamily] = {
    f.name: f for f in (AL2(), AL2023(), Bottlerocket(), Ubuntu(), Windows(), Custom())
}


def resolve_ami_family(name: str) -> AMIFamily:
    fam = AMI_FAMILIES.get(name)
    if fam is None:
        raise ValueError(f"unknown AMI family {name!r}; known: {sorted(AMI_FAMILIES)}")
    return fam


def storage_config(node_class: NodeClass) -> "StorageConfig":
    """NodeClass storage knobs + its AMI family's root device → the
    lattice's per-type ephemeral-storage resolution inputs (reference
    types.go:210-240 ephemeralStorage)."""
    from ..lattice.tensors import StorageConfig
    fam = resolve_ami_family(node_class.ami_family)
    return StorageConfig(
        instance_store_policy=node_class.instance_store_policy,
        block_device_mappings=tuple(node_class.block_device_mappings),
        ephemeral_block_device=fam.ephemeral_block_device,
        custom_ami_family=fam.name == "Custom")


class AMIProvider:
    def __init__(self, cloud: FakeCloud, clock: Optional[Clock] = None,
                 cluster_name: str = "sim",
                 cluster_endpoint: Optional[str] = None):
        """``cluster_endpoint`` overrides network discovery for node
        bootstrap userdata (the reference's CLUSTER_ENDPOINT option,
        operator.go:119-124; None = discover)."""
        self.cloud = cloud
        self.cluster_name = cluster_name
        self.cluster_endpoint = cluster_endpoint
        self._cache = TTLCache(AMI_TTL, clock)

    def list(self, node_class: NodeClass, k8s_version: str) -> List[ResolvedAMI]:
        """Resolve AMIs: explicit selector terms win; otherwise the family's
        SSM default parameters (ami.go:136-181). Newest per arch wins
        (ami.go:91-102 sorts by creation date)."""
        key = f"{node_class.name}:{k8s_version}:{node_class.ami_family}:{node_class.ami_selector_terms!r}"

        def fetch():
            images: Dict[str, Image] = {}
            if node_class.ami_selector_terms:
                for t in node_class.ami_selector_terms:
                    if t.id:
                        for im in self.cloud.network.describe_images(ids=[t.id]):
                            images[im.id] = im
                    elif t.name:
                        for im in self.cloud.network.describe_images(names=[t.name]):
                            images[im.id] = im
                    else:
                        for im in self.cloud.network.describe_images(tags=dict(t.tags)):
                            images[im.id] = im
            else:
                fam = resolve_ami_family(node_class.ami_family)
                for arch, param in fam.default_ami_ssm_parameters(k8s_version).items():
                    try:
                        ami_id = self.cloud.network.get_parameter(param)
                    except NotFoundError:
                        continue
                    for im in self.cloud.network.describe_images(ids=[ami_id]):
                        images[im.id] = im
            best_per_arch: Dict[str, Image] = {}
            for im in images.values():
                if im.deprecated:
                    continue
                cur = best_per_arch.get(im.arch)
                if cur is None or im.creation_date > cur.creation_date:
                    best_per_arch[im.arch] = im
            return [ResolvedAMI(id=im.id, name=im.name, arch=im.arch)
                    for im in sorted(best_per_arch.values(), key=lambda i: i.arch)]

        return self._cache.get_or_compute(key, fetch)

    def resolve_launch_parameters(self, node_class: NodeClass,
                                  k8s_version: str,
                                  cluster_dns: Optional[str] = None) -> List[LaunchParameters]:
        """One launch parameter set per resolved AMI (resolver.go:122-165)."""
        fam = resolve_ami_family(node_class.ami_family)
        endpoint = self.cluster_endpoint or self.cloud.network.cluster_endpoint
        return [LaunchParameters(
                    ami=ami, arch=ami.arch,
                    user_data=fam.user_data(node_class, self.cluster_name,
                                            endpoint, cluster_dns=cluster_dns))
                for ami in self.list(node_class, k8s_version)]

    def reset(self) -> None:
        self._cache.flush()
