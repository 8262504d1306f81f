"""The ``api`` phase of ``chip_smoke.py``, part (a), cut down, on both
packages, on the CPU.

The cfg5 wave (``workloads.config5_full_scale``) cut to every 16th pod
(3,125 pods of all 30 shapes, 63 of them GPU and 25 Neuron pods) on the
real catalog. A ``FakeAPIServer`` with its indexes and admission is
served over HTTP with a bearer token; the three NodePools and the first
62 pods (1,000 // 16) are POSTed over REST, the rest enter through
``KubeClient.create_pods``, and a watch on ``GET /apis/pods?watch=1``
runs over HTTP in a thread. An API-mode Operator on the FakeClock (the
port's on the CPU) takes one forced pass, then registration passes. Both
packages must bind every pod, agree on the server's claims, nodes and
bindings, see every binding on the watch stream, and make the same plan
(``plan_semantic_dict``), which on the port must also be the plan of a
direct ``solve_relaxed`` of the same pods under the NodePools as
admission stored them (defaulting adds the reference's default
requirements, on-demand among them, so API mode's plan is not direct
mode's plan of the raw pools: by design, on both packages).

Tolerance: none.
"""

import json
import threading
import time
import urllib.request

import test_torch_cases as cases
from test_torch_api_slice import PKGS, TOKEN, _call
from test_torch_replay import one_torch_thread  # noqa: F401 (autouse)

STRIDE = 16                      # the cut of the cfg5 wave
REST_PODS = 1000 // STRIDE       # pods POSTed one by one over REST


class _Watch(threading.Thread):
    """``GET /apis/pods?watch=1`` over HTTP: the names of the pods it saw
    bound."""

    def __init__(self, base, token):
        super().__init__(daemon=True)
        self.url = f"{base}/apis/pods?watch=1&resourceVersion=0"
        self.token = token
        self.bound = set()
        self.stop = threading.Event()
        self.error = None

    def run(self):
        r = urllib.request.Request(
            self.url, headers={"Authorization": f"Bearer {self.token}"})
        try:
            with urllib.request.urlopen(r, timeout=60) as resp:
                while not self.stop.is_set():
                    line = resp.readline()
                    if not line:
                        return
                    ev = json.loads(line)
                    if ev["type"] == "ERROR":
                        raise RuntimeError(f"watch ended: {ev}")
                    obj = ev.get("object") or {}
                    if obj.get("spec", {}).get("nodeName"):
                        self.bound.add(obj["metadata"]["name"])
        except Exception as e:
            if not self.stop.is_set():
                self.error = e


def _wave_inputs():
    W = cases.mod(cases.TORCH_PKG, "workloads")
    serde = cases.mod(cases.TORCH_PKG, "apis.serde")
    pods, pools, _ = W.config5_full_scale()
    return ([serde.pod_to_dict(p) for p in pods[::STRIDE]],
            [serde.nodepool_to_dict(p) for p in pools])


_LATTICES = {}


def _real_lattice(pkg):
    if pkg not in _LATTICES:
        L = cases.mod(pkg, "lattice")
        load = cases.mod(pkg, "lattice.realdata").load_catalog
        _LATTICES[pkg] = L.build_lattice(load(None, require_price=True))
    return _LATTICES[pkg]


def _server_truth(server):
    claims = sorted(
        (o["metadata"]["name"], o["spec"]["nodePool"], o["spec"]["instanceType"],
         o["spec"]["zone"], o["spec"]["capacityType"], o["spec"]["phase"])
        for o in server.list("nodeclaims")[0])
    nodes = sorted((o["metadata"]["name"], o["spec"]["nodeClaim"],
                    o["spec"]["labels"].get("node.kubernetes.io/instance-type"))
                   for o in server.list("nodes")[0])
    bindings = sorted((o["metadata"]["name"], o["spec"].get("nodeName"))
                      for o in server.list("pods")[0])
    return {"claims": claims, "nodes": nodes, "bindings": bindings}


def _api_wave(pkg, pod_dicts, pool_dicts):
    """The api phase's part (a) on ``pkg``: (server truth, the pass's
    plan, the pods the watch saw bound, the plan of a direct solve)."""
    m = lambda name: cases.mod(pkg, name)  # noqa: E731
    kube, serde = m("kube"), m("apis.serde")
    lat = _real_lattice(pkg)
    clock = m("utils.clock").FakeClock()
    server = kube.FakeAPIServer(clock=clock)
    kube.install_default_indexes(server)
    kube.install_admission(server)
    httpd = m("kube.httpserver").serve(server, 0, token=TOKEN)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    watch = _Watch(base, TOKEN)
    try:
        for d in pool_dicts:
            _call("POST", f"{base}/apis/nodepools", d, TOKEN)
        cloud = m("cloud").FakeCloud(clock)
        # the wave's /20 subnets (the port's workloads.wave_cloud)
        for i, sub in enumerate(sorted(cloud.network.subnets.values(),
                                       key=lambda s: s.id)):
            sub.cidr = f"10.{i}.0.0/20"
            sub.available_ips = 4091
        kw = {"device": "cpu"} if pkg == cases.TORCH_PKG else {}
        op = m("operator").Operator(
            options=m("operator").Options(registration_delay=2.0),
            lattice=lat, cloud=cloud, clock=clock, api_server=server, **kw)
        watch.start()
        for d in pod_dicts[:REST_PODS]:
            _call("POST", f"{base}/apis/pods", d, TOKEN)
        errs = kube.KubeClient(server).create_pods(
            [serde.pod_from_dict(d) for d in pod_dicts[REST_PODS:]])
        assert not any(errs)
        results = []
        orig = op.provisioner.provision_once

        def provision_once(*a, **k):
            results.append(orig(*a, **k))
            return results[-1]
        op.provisioner.provision_once = provision_once
        op.run_once(force_provision=True)
        assert len(results) == 1 and not results[0].plan.degraded
        for _ in range(5):
            if all(o["spec"].get("nodeName")
                   for o in server.list("pods")[0]):
                break
            clock.step(op.options.registration_delay + 0.1)
            op.sync_once()
            op.lifecycle.reconcile()
            op.sync_once()
        deadline = time.monotonic() + 60
        while len(watch.bound) < len(pod_dicts) and watch.is_alive() \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert watch.error is None, watch.error
        # the pools as admission stored them: defaulting added the
        # reference's default requirements (on-demand, amd64, linux)
        admitted = [serde.nodepool_from_dict(o["spec"])
                    for o in server.list("nodepools")[0]]
        return (_server_truth(server), results[0].plan, set(watch.bound),
                admitted)
    finally:
        watch.stop.set()
        httpd.shutdown()


def test_api_wave_cut_down_equal_between_packages():
    pod_dicts, pool_dicts = _wave_inputs()
    assert len(pod_dicts) == 3125 and len(pool_dicts) == 3
    out = {pkg: _api_wave(pkg, pod_dicts, pool_dicts) for pkg in PKGS}
    (jt, jplan, jwatch, _), (tt, tplan, twatch, admitted) = (
        out[cases.JAX_PKG], out[cases.TORCH_PKG])
    names = {d["name"] for d in pod_dicts}
    for truth, watched in ((jt, jwatch), (tt, twatch)):
        assert all(node for _, node in truth["bindings"])
        assert {p for p, _ in truth["bindings"]} == names
        assert watched == names
        assert len(truth["claims"]) == len(truth["nodes"])
    assert tt == jt
    JS, TS = (cases.mod(p, "apis.serde") for p in PKGS)
    assert json.dumps(TS.plan_semantic_dict(tplan)) \
        == json.dumps(JS.plan_semantic_dict(jplan))
    # API mode plans as a direct solve of the same pods under the
    # admitted pools does, node by node
    S = cases.mod(cases.TORCH_PKG, "solver")
    direct = S.Solver(_real_lattice(cases.TORCH_PKG), device="cpu") \
        .solve_relaxed([TS.pod_from_dict(d) for d in pod_dicts], admitted)
    assert json.dumps(TS.plan_semantic_dict(tplan)) \
        == json.dumps(TS.plan_semantic_dict(direct))
    assert [p.name for p in admitted] == ["default", "arm", "gpu"]
    assert len(tplan.new_nodes) == len(tt["claims"])
