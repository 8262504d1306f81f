"""Real-data catalog loader: JSON dumps of actual EC2 facts → specs.

The alternative to the synthetic catalog (lattice/catalog.py): a JSON
document mirroring the reference's generated data tables (hack/code/
generators → zz_generated.{describe_instance_types,pricing_aws,bandwidth,
vpclimits}.go) loads into the SAME InstanceTypeSpec rows build_lattice
consumes — so the solver, overhead math, and bench run over real
hardware shapes, real ENI/pod-density limits, and real prices.

A checked-in dump converted from the reference's own fixtures ships at
``lattice/data/reference_catalog.json`` (tools/import_reference_data.py
regenerates it); ``bench.py --catalog`` and tests load arbitrary dumps
with the same schema::

    {"region": "us-east-1",
     "types": [{"name": "m5.large", "vcpus": 2, "memoryMiB": 8192,
                "arch": "amd64", "cpuManufacturer": "intel",
                "hypervisor": "nitro", "bareMetal": false,
                "enis": 3, "ipv4PerEni": 10, "podEniCount": 9,
                "networkBandwidthMbps": 750, "localNvmeGb": 0,
                "efaCount": 0, "odPrice": 0.096,
                "gpuName": null, ... "acceleratorCount": 0}, ...]}
"""

from __future__ import annotations

import json
import pathlib
import re
from typing import List, Optional, Union

from .catalog import InstanceTypeSpec

DEFAULT_PATH = pathlib.Path(__file__).parent / "data" / "reference_catalog.json"

_FAMILY_RE = re.compile(r"^([a-z]+?)(\d+)([a-z0-9-]*)$")


def parse_family(family: str):
    """'m6idn' -> (category 'm', generation 6); 'trn1' -> ('trn', 1)."""
    m = _FAMILY_RE.match(family)
    if m is None:
        return family, 0
    return m.group(1), int(m.group(2))


def spec_from_dict(d: dict) -> InstanceTypeSpec:
    name = d["name"]
    family, _, size = name.partition(".")
    category, generation = parse_family(family)
    hypervisor = d.get("hypervisor", "nitro")
    if d.get("bareMetal"):
        hypervisor = ""   # metal: no hypervisor (overhead.py's convention)
    return InstanceTypeSpec(
        name=name, family=family, category=category,
        generation=generation, size=size or "large",
        vcpus=int(d["vcpus"]), memory_mib=int(d["memoryMiB"]),
        arch=d.get("arch", "amd64"),
        cpu_manufacturer=d.get("cpuManufacturer", "intel"),
        hypervisor=hypervisor,
        enis=int(d["enis"]), ipv4_per_eni=int(d["ipv4PerEni"]),
        network_bandwidth_mbps=int(d.get("networkBandwidthMbps", 0)),
        local_nvme_gb=int(d.get("localNvmeGb", 0)),
        gpu_name=d.get("gpuName"),
        gpu_manufacturer=d.get("gpuManufacturer"),
        gpu_count=int(d.get("gpuCount", 0)),
        gpu_memory_mib=int(d.get("gpuMemoryMiB", 0)),
        accelerator_name=d.get("acceleratorName"),
        accelerator_manufacturer=d.get("acceleratorManufacturer"),
        accelerator_count=int(d.get("acceleratorCount", 0)),
        efa_count=int(d.get("efaCount", 0)),
        pod_eni_count=int(d.get("podEniCount", 0)),
        od_price=float(d.get("odPrice", 0.0)),
        spot_prices=(tuple(sorted(
            (z, float(p)) for z, p in d["spotPrices"].items()))
            if d.get("spotPrices") else None),
    )


def load_catalog(path: Union[str, pathlib.Path, None] = None,
                 require_price: bool = False) -> List[InstanceTypeSpec]:
    """Load a real-data JSON catalog into InstanceTypeSpec rows (sorted
    by name, like build_catalog). ``require_price`` drops entries without
    an on-demand price — an unpriced type would pack as free."""
    doc = json.loads(pathlib.Path(path or DEFAULT_PATH).read_text())
    specs = [spec_from_dict(t) for t in doc["types"]]
    if require_price:
        specs = [s for s in specs if s.od_price > 0]
    return sorted(specs, key=lambda s: s.name)
