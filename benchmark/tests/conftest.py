"""Shared set-up of the benchmark's CPU tests: the checkout's root on the
path, the ``card`` marker, and a tiny cell (22.05 kHz, fft 1024, 2-3 s
takes) that drives the whole harness on the CPU through the program's
plain versions."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "tape192_stereo.json").read_text())
    cfg.update(sample_rate=22050, fft_size=1024, sinc_quality=16, f0_hz=2000.0)
    return cfg


TINY_TRAFFIC = {
    "t3": {"entry": "fused_single", "layout": "take", "take_seconds": [3], "pool": 2,
           "warm_calls": 1, "trace_calls": 2},
    "b3": {"entry": "fused_batch", "layout": "batch", "take_seconds": [2, 2.5, 3],
           "pool": 2, "warm_calls": 1, "trace_calls": 2},
}
# ``tiny.f3``: a 2.995 s stereo take (516 hops, so the file path's end trim can
# cut a segment) as a 24-bit WAV a call, through the file path
TINY_FILE_TRAFFIC = {"entry": "file_fast", "pipeline": "file_fast", "layout": "take",
                     "take_seconds": [516 * 128 / 22050], "pool": 4, "warm_calls": 1,
                     "trace_calls": 4}
# Cells whose files stay under benchmark/ while BENCHMARK.json leaves them out:
# ``tape192.batch8``'s runs spread by more than half the largest bound on the
# card (PERF.md), and a spec entry alone brings it back.
KEPT_ASIDE = [{"name": "tape192.batch8", "config": "tape192_stereo", "traffic": "batch8",
               "chips": 1, "why": "8 mono takes of 20-40 s (240 s) a call padded to 40 s"}]


def with_kept_aside(spec: dict) -> dict:
    """``spec`` with the cells of :data:`KEPT_ASIDE` among its workloads."""
    return {**spec, "workloads": spec["workloads"] + KEPT_ASIDE}


# CPU readings of the program on 12 seeds: 4.8e-5, 4.7e-7, 3.4e-5; of the TF32
# control: 3.8e-4, 7.9e-5, 2.3e-3; of TF32 in the sinc alone: 3.8e-4, 7.9e-5, 1.5e-4
TINY_FILE_LIMITS = {"residual_gap": 1.5e-4, "residual_rms": 8e-6, "timing_gap": 1e-4}
# CPU readings of the program on 4 seeds: 4.4e-5, 5.2e-7, 2.0e-4; of the TF32
# control: 3.8e-4, 7.9e-5, 2.7e-3; of TF32 in the sinc alone: 3.7e-4, 7.9e-5
TINY_LIMITS = {"residual_gap": 1e-4, "residual_rms": 8e-6, "timing_gap": 1.5e-3}


@pytest.fixture
def tiny_bench(tmp_path):
    """(bench_dir, spec) of a copy of the benchmark holding the tiny cells
    ``tiny.t3`` (one stereo take a call) and ``tiny.b3`` (a batch of three
    mono takes of mixed length), each made only of new data files."""
    return make_tiny_bench(tmp_path, TINY_LIMITS)


def make_tiny_bench(tmp_path, limits: dict):
    """:func:`tiny_bench` with ``limits`` for both tiny cells."""
    bench = tmp_path / "benchmark"
    for kind in ("configs", "traffic", "limits"):
        (bench / kind).mkdir(parents=True)
    for kind in ("entries", "metrics"):
        (bench / kind).symlink_to(BENCH / kind)
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "tests", "reduced": [], "why": "tests",
                            "file": "benchmark/configs/tiny.json"})
    for traffic, body in TINY_TRAFFIC.items():
        add_tiny_cell(bench, spec, traffic, body, limits)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench, spec


def add_tiny_cell(bench, spec: dict, traffic: str, body: dict, limits: dict):
    """The cell ``tiny.<traffic>`` of the tiny configuration: its traffic and
    limits files, its spec entry, and its name in every metric's
    ``workloads`` list that holds a cell of this benchmark with the same
    pipeline, since it opens the spans and counters that they read."""
    cell = f"tiny.{traffic}"
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(body))
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    same_pipeline = {w["name"] for w in spec["workloads"]
                     if (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
                     and json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
                     .get("pipeline") == body.get("pipeline")}
    spec["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic, "chips": 1,
                              "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if same_pipeline & set(m.get("workloads", ())):
            m["workloads"].append(cell)


def make_tiny_file_bench(tmp_path, limits: dict = TINY_FILE_LIMITS):
    """:func:`make_tiny_bench` with the cell ``tiny.f3`` (the file path, the
    ``file_fast`` entry and pipeline) added as new data files and a spec
    entry: a traffic file, a limits file and the benchmark's pipelines."""
    bench, spec = make_tiny_bench(tmp_path, TINY_LIMITS)
    (bench / "pipelines").symlink_to(BENCH / "pipelines")
    add_tiny_cell(bench, spec, "f3", TINY_FILE_TRAFFIC, limits)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench, spec
