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
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(body))
        cell = f"tiny.{traffic}"
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic,
                                  "chips": 1, "why": "tests"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench, spec
