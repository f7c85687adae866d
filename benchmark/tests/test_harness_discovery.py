"""The benchmark is driven by data: every cell, configuration, traffic
mix, entry and metric that ``BENCHMARK.json`` names is found by name, and
a cell added as new files runs with no edit to a file already there."""

import json
import re
import time

import pytest
from conftest import BENCH, ROOT, TINY_LIMITS

from benchmark.lib import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.cell_files(BENCH, SPEC, cell)
    assert callable(c.entry.prepare) and callable(c.entry.answers) and callable(c.entry.takes)
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.traffic["pool"] >= 2 and c.traffic["trace_calls"] >= c.traffic["pool"]
    e2e = {m["name"] for m in harness.metrics_of(SPEC, "end_to_end", cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(SPEC, "per_layer", cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.load_module(BENCH, "metrics", metric).read)


def test_spec_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for cfg in SPEC["configs"]:
        assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("benchmark/")
        assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all(m["moves"] in {e["name"] for e in SPEC["end_to_end"]} for m in SPEC["per_layer"])
    assert all("\n" not in layer for layer in layers)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_a_cell_added_as_new_files_runs(tiny_bench, tmp_path):
    """A new configuration, traffic mix, entry, metric and limit, each a new
    file, and a new entry in the spec: the harness runs the cell and reads
    the new metric with no other change."""
    bench, spec = tiny_bench
    entries = bench / "entries"
    entries.unlink()
    entries.mkdir()
    for f in (BENCH / "entries").glob("*.py"):
        (entries / f.name).write_text(f.read_text())
    (entries / "dummy_single.py").write_text((BENCH / "entries" / "fused_single.py").read_text())
    metrics = bench / "metrics"
    metrics.unlink()
    metrics.mkdir()
    for f in (BENCH / "metrics").glob("*.py"):
        (metrics / f.name).write_text(f.read_text())
    (metrics / "calls_done.py").write_text("def read(run):\n    return len(run.latencies)\n")
    (bench / "traffic" / "dummy.json").write_text(json.dumps(
        {"entry": "dummy_single", "layout": "take", "take_seconds": [2], "pool": 1,
         "warm_calls": 1, "trace_calls": 1}))
    (bench / "limits" / "tiny.dummy.json").write_text(json.dumps(TINY_LIMITS))
    spec["workloads"].append({"name": "tiny.dummy", "config": "tiny", "traffic": "dummy",
                              "chips": 1, "why": "a dummy cell"})
    spec["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tiny.dummy"]})
    result, checks, _ = harness.run_cell("tiny.dummy", 987654321987, 0.5, False,
                                      t0=time.perf_counter(), bench_dir=bench,
                                      device="cpu", spec=spec)
    assert result["correct"], checks
    assert result["metrics"]["calls_done"]["value"] == result["attempted"] >= 1
    assert set(result["metrics"]) == {"x_realtime", "setup_s", "calls_done"}
    assert list(result)[-1] == "checks"
