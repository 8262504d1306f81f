"""Import REAL EC2 data from the reference's data tables into the
framework's JSON catalog format, for this package.

The counterpart of the repository's ``tools/import_reference_data.py``:
the same parse and the same document, written by default to this
package's ``lattice/data/reference_catalog.json`` (which equals the JAX
package's byte for byte).

The reference compiles scraped reality into generated sources; the
spec-of-record breadth catalog is its generated instance-types doc
(website/content/en/preview/reference/instance-types.md — 759 per-type
sections with labels + computed allocatable, generated by
hack/docs/instancetypes_gen_docs.go), which this tool joins with:

- pkg/providers/instancetype/zz_generated.vpclimits.go — authoritative
  ENI/IP/trunking table (eni-max-pods math inputs),
- pkg/providers/instancetype/zz_generated.bandwidth.go — network Mbps,
- pkg/providers/pricing/zz_generated.pricing_aws.go — real on-demand
  $/hr (us-east-1).

These are DATA tables (facts about EC2, not code); the emitted JSON is
the schema lattice/realdata.py loads, so the solver, overhead math, and
bench run over real instance types, real ENI/pod-density limits, and
real prices instead of the synthetic catalog.

Spot prices: the reference ships NO static spot table — it initializes
spot = on-demand per type and overlays live per-AZ data from
DescribeSpotPriceHistory at runtime (pkg/providers/pricing/pricing.go:
348-391, populateInitialSpotPricing). Lacking a real snapshot, this
tool emits per-AZ spot prices DERIVED from the real on-demand price by
the framework's deterministic discount model (lattice/catalog.py
spot_price, ~30-45% of OD), flagged "spotSource": "derived-discount" in
the document so consumers know the spot axis is modeled, not measured.

The doc's per-type "Resources" table (the reference's own computed
allocatable under AL2 / ENI-limited density / no block-device mappings)
is preserved per type under "refAllocatable" so tools/allocatable_diff.py
can diff our overhead math against the reference's published numbers.

Usage:
  python -m karpenter_provider_aws_tpu_torch.tools.import_reference_data \
      --reference <checkout of the reference> \
      --out karpenter_provider_aws_tpu_torch/lattice/data/reference_catalog.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re

from ..lattice import catalog as cat
from ..lattice import realdata


_SECTION_RE = re.compile(r"^### `([^`]+)`$", re.M)
_ROW_RE = re.compile(r"^ \|([^|]+)\|([^|]+)\|$", re.M)
_L = "karpenter.k8s.aws/instance-"


def _qty_milli(v: str) -> int:
    """'3920m' -> 3920, '4' -> 4000 (cpu quantity to millicores)."""
    return int(v[:-1]) if v.endswith("m") else int(v) * 1000


def _qty_mi(v: str) -> int:
    """'6804Mi' -> 6804, '17Gi' -> 17408."""
    if v.endswith("Mi"):
        return int(v[:-2])
    if v.endswith("Gi"):
        return int(v[:-2]) * 1024
    return int(v)


def parse_instance_types_md(path: pathlib.Path) -> dict:
    """The reference's generated instance-types doc → {name: type dict}.

    Each `### \\`type\\`` section carries two markdown tables: Labels
    (the karpenter.k8s.aws/instance-* well-known labels) and Resources
    (the reference's computed allocatable, including extended resources
    nvidia.com/gpu / habana.ai/gaudi / aws.amazon.com/neuron /
    vpc.amazonaws.com/{efa,pod-eni})."""
    text = path.read_text()
    sections = _SECTION_RE.split(text)[1:]   # [name, body, name, body, ...]
    out = {}
    for name, body in zip(sections[::2], sections[1::2]):
        rows = dict((k.strip(), v.strip()) for k, v in _ROW_RE.findall(body))
        labels = {k: v for k, v in rows.items() if "/" in k}
        # rows after "#### Resources" share the same |k|v| shape; split
        # by position instead: resources are the keys with no "/" OR the
        # extended-resource FQDNs
        res_part = body.split("#### Resources", 1)
        resources = (dict((k.strip(), v.strip())
                          for k, v in _ROW_RE.findall(res_part[1]))
                     if len(res_part) == 2 else {})

        gm = labels.get(_L + "gpu-manufacturer")
        size = labels.get(_L + "size", name.partition(".")[2])
        gpus = int(resources.get("nvidia.com/gpu", 0) or 0) + \
            int(resources.get("habana.ai/gaudi", 0) or 0) + \
            int(resources.get("amd.com/gpu", 0) or 0)
        neurons = int(resources.get("aws.amazon.com/neuron", 0) or 0)
        t = {
            "name": name,
            "arch": labels.get("kubernetes.io/arch", "amd64"),
            "cpuManufacturer": labels.get(_L + "cpu-manufacturer", "intel"),
            "hypervisor": labels.get(_L + "hypervisor", ""),
            "bareMetal": size == "metal",
            "vcpus": int(labels[_L + "cpu"]),
            "memoryMiB": int(labels[_L + "memory"]),
            "localNvmeGb": int(labels.get(_L + "local-nvme", 0)),
            "networkBandwidthMbps": int(
                labels.get(_L + "network-bandwidth", 0)),
            "gpuName": labels.get(_L + "gpu-name"),
            "gpuManufacturer": gm,
            "gpuCount": int(labels.get(_L + "gpu-count", 0)),
            "gpuMemoryMiB": int(labels.get(_L + "gpu-memory", 0)),
            "acceleratorName": labels.get(_L + "accelerator-name"),
            "acceleratorManufacturer": labels.get(
                _L + "accelerator-manufacturer"),
            "acceleratorCount": int(labels.get(_L + "accelerator-count", 0)),
            "efaCount": int(resources.get("vpc.amazonaws.com/efa", 0) or 0),
            # the reference's own computed allocatable (AL2, ENI-limited
            # density, no BDMs) — kept for allocatable_diff validation
            "refAllocatable": {
                "cpuMilli": _qty_milli(resources.get("cpu", "0")),
                "memoryMi": _qty_mi(resources.get("memory", "0")),
                "ephemeralStorageMi": _qty_mi(
                    resources.get("ephemeral-storage", "0")),
                "pods": int(resources.get("pods", 0)),
                "gpus": gpus,
                "neurons": neurons,
                "podEni": int(resources.get("vpc.amazonaws.com/pod-eni", 0)
                              or 0),
            },
        }
        out[name] = t
    return out


def parse_prices(path: pathlib.Path, region: str = "us-east-1") -> dict:
    """zz_generated.pricing_aws.go → {type: $/hr} for one region."""
    text = path.read_text()
    m = re.search(r'"%s":\s*\{(.*?)\n\t\},' % re.escape(region), text, re.S)
    if m is None:
        raise SystemExit(f"region {region} not in {path}")
    return {t: float(p) for t, p in
            re.findall(r'"([^"]+)":\s*([0-9.]+)', m.group(1))}


def parse_bandwidth(path: pathlib.Path) -> dict:
    text = path.read_text()
    return {t: int(b) for t, b in
            re.findall(r'"([^"]+)":\s+(\d+),', text)}


def parse_vpclimits(path: pathlib.Path) -> dict:
    """zz_generated.vpclimits.go → {type: {enis, ipv4PerEni,
    podEniCount}} (BranchInterface = security-groups-for-pods trunking)."""
    text = path.read_text()
    out = {}
    for m in re.finditer(
            r'"([^"]+)":\s*\{\s*Interface:\s*(\d+),\s*'
            r'IPv4PerInterface:\s*(\d+),\s*'
            r'IsTrunkingCompatible:\s*(\w+),\s*'
            r'BranchInterface:\s*(\d+),', text):
        name, enis, ipv4, trunk, branch = m.groups()
        out[name] = {"enis": int(enis), "ipv4PerEni": int(ipv4),
                     "podEniCount": int(branch) if trunk == "true" else 0}
    return out


def _derive_eni_shape(pods: int):
    """Invert eni-max-pods (pods = enis*(ipv4-1)+2) for the handful of
    types absent from vpclimits, preferring real AWS IPv4/ENI counts."""
    for ipv4 in (50, 30, 15, 10, 6, 5, 4, 3, 2):
        enis, rem = divmod(pods - 2, ipv4 - 1)
        if rem == 0 and 1 <= enis <= 16:
            return enis, ipv4
    return 4, 15    # conservative default (58 pods)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reference", required=True,
                   help="a checkout of the reference repository")
    p.add_argument("--region", default="us-east-1")
    p.add_argument("--out", default=str(
        pathlib.Path(__file__).resolve().parent.parent /
        "lattice" / "data" / "reference_catalog.json"))
    args = p.parse_args(argv)

    ref = pathlib.Path(args.reference)
    hw = parse_instance_types_md(
        ref / "website" / "content" / "en" / "preview" / "reference" /
        "instance-types.md")
    prices = parse_prices(
        ref / "pkg" / "providers" / "pricing" / "zz_generated.pricing_aws.go",
        args.region)
    bandwidth = parse_bandwidth(
        ref / "pkg" / "providers" / "instancetype" /
        "zz_generated.bandwidth.go")
    vpc = parse_vpclimits(
        ref / "pkg" / "providers" / "instancetype" /
        "zz_generated.vpclimits.go")

    # the reference hardcodes Trainium identity pending DescribeInstance-
    # Types support (types.go:281-291 awsNeurons); the generated doc still
    # labels trn1 "inferentia" — mirror the code's facts, not the doc's
    TRN1 = {"trn1.2xlarge", "trn1.32xlarge", "trn1n.32xlarge"}

    types = []
    for name, t in sorted(hw.items()):
        t = dict(t)
        if name in TRN1:
            t["acceleratorName"] = "Trainium"
        v = vpc.get(name)
        pods = t["refAllocatable"]["pods"]
        if v:
            # vpclimits is authoritative for IPv4/ENI + trunking, but its
            # Interface count spans ALL network cards; the VPC CNI (and so
            # the reference's ENILimitedPods, types.go:319-332) only uses
            # the DEFAULT card. Invert the doc's published pods count
            # (pods = enis*(ipv4-1)+2) to recover the default-card ENIs —
            # exact for every type the doc covers.
            ipv4 = v["ipv4PerEni"]
            card0, rem = divmod(pods - 2, ipv4 - 1)
            t["enis"] = card0 if rem == 0 and card0 >= 1 else v["enis"]
            t["totalEnis"] = v["enis"]
            t["ipv4PerEni"] = ipv4
            t["podEniCount"] = v.get("podEniCount", 0)
        else:
            enis, ipv4 = _derive_eni_shape(pods)
            t["enis"], t["ipv4PerEni"] = enis, ipv4
            t["totalEnis"] = enis
            t["podEniCount"] = t["refAllocatable"]["podEni"]
        if not t["networkBandwidthMbps"]:
            t["networkBandwidthMbps"] = bandwidth.get(name, 0)
        t["odPrice"] = prices.get(name, 0.0)
        types.append(t)

    # per-AZ spot prices: derived discount over the real OD price using
    # the framework's deterministic spot model, emitted as data so the
    # pricing axis is loaded (and overlayable) rather than synthesized
    # at lattice-build time
    for t in types:
        if t["odPrice"] <= 0:
            t["spotPrices"] = {}
            continue
        spec = realdata.spec_from_dict(t)
        t["spotPrices"] = {
            z: cat.spot_price(spec, z)
            for z in cat.ZONES
            if z not in cat.LOCAL_ZONES
            and cat.offering_available(spec, z, "spot")}

    doc = {
        "source": ("reference instance-types.md + zz_generated "
                   "pricing/bandwidth/vpclimits tables"),
        "region": args.region,
        "spotSource": "derived-discount (no static spot table upstream; "
                      "reference initializes spot=od and overlays "
                      "DescribeSpotPriceHistory at runtime)",
        "types": types,
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {out}: {len(types)} types "
          f"({sum(1 for t in types if t['odPrice'] > 0)} priced, "
          f"{sum(1 for t in types if t.get('podEniCount'))} trunking, "
          f"{sum(1 for t in types if t['gpuCount'])} gpu, "
          f"{sum(1 for t in types if t['acceleratorCount'])} accel, "
          f"{sum(1 for t in types if t['efaCount'])} efa)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
