"""A later change adds a cell as files and entries: the harness finds a new
configuration, traffic mix and metric by name, and no file it had changes."""

import hashlib
import io
import json
import time


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and ".cache" not in p.parts}


def test_a_new_cell_is_data(checkout):
    base = checkout / "benchmark"
    before = digest(checkout)
    cfg = json.loads((base / "configs" / "wave50k.json").read_text())
    cfg.update(name="tinywave", shapes=3, pods=120)
    (base / "configs" / "tinywave.json").write_text(json.dumps(cfg))
    (base / "configs" / "tinywave.py").write_text((base / "configs" / "wave50k.py").read_text())
    (base / "traffic" / "trickle.json").write_text(json.dumps(
        {"driver": "waves", "why": "small waves", "draws": [3, 4, 5], "warmup_rounds": 1,
         "trace_steps": 1, "kernels": ["argmin"]}))
    (base / "metrics" / "waves_done.py").write_text(
        '"""waves_done: steps in the window."""\n\n\ndef read(ctx):\n    return len(ctx.records)\n')
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinywave", "source": "a test", "file":
                             "benchmark/configs/tinywave.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tinywave.trickle", "config": "tinywave",
                               "traffic": "trickle", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "cost_vs_ffd":
            m["workloads"].append("tinywave.trickle")
    bench["end_to_end"].append({"name": "waves_done", "unit": "waves", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tinywave.trickle"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    from benchmark import harness
    out = harness.run("tinywave.trickle", 99, 0.3, False, time.perf_counter(), device="cpu",
                      root=checkout, log=io.StringIO())
    assert out["correct"] is True
    assert out["metrics"]["waves_done"]["value"] >= 1
    assert {"setup_s", "cost_vs_ffd", "waves_done"} <= set(out["metrics"])
    after = digest(checkout)
    assert {k: v for k, v in after.items() if k in before} == before
