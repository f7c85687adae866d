"""The harness drives a whole run on the CPU (the look for a card skipped)
with the timed path broken underneath, and ``correct`` comes out false for
each fault a cell of this benchmark can have: an answer altered where it
is produced, an answer of an earlier call handed back (the state left
unchanged), and half of a batch left out.  A sound run comes out true.
Each is run once with the tiny cells' own limits and once with each real
cell's limits file, on the tiny cell of the same entry."""

import json
import time

import pytest
from conftest import BENCH, ROOT, TINY_LIMITS, make_tiny_bench, with_kept_aside

from benchmark.lib import harness
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY_OF_ENTRY = {"fused_single": "tiny.t3", "fused_batch": "tiny.b3"}
ENTRY_FN = {"tiny.t3": "restore_fused_device", "tiny.b3": "restore_fused_takes"}


def entry_of(cell: dict) -> str:
    return json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())["entry"]


# (the cell whose limits are used, or None for the tiny cells' own; the tiny cell);
# the file cells' faults are test_harness_file_faults.py's
LIMITS_ON = [(None, "tiny.t3"), (None, "tiny.b3")] + [
    (w["name"], TINY_OF_ENTRY[entry_of(w)]) for w in with_kept_aside(SPEC)["workloads"]
    if entry_of(w) in TINY_OF_ENTRY]


def run(bench_spec, cell, trace=False):
    bench, spec = bench_spec
    result, checks, _ = harness.run_cell(cell, 2 ** 31 + 12345, 0.5, trace,
                                         t0=time.perf_counter(), bench_dir=bench, device="cpu",
                                         spec=spec)
    return result, checks


def altered(fn):
    def broken(*a, **k):
        out = fn(*a, **k).clone()
        out[..., out.shape[-2] // 2, 3] += 0.01
        return out
    return broken


def stale(fn):
    first = []

    def broken(*a, **k):
        out = fn(*a, **k)
        if not first:
            first.append(out)
        return first[0]
    return broken


def half_batch(fn):
    def broken(xb, *a, **k):
        out = fn(xb, *a, **k).clone()
        out[out.shape[0] // 2:] = 0.0
        return out
    return broken


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["tiny.t3", "tiny.b3"])
def test_sound_run_is_correct(tiny_bench, cell, trace):
    """A sound run, plain and traced (on the CPU the trace holds no device
    event, so only the metrics that need none are read)."""
    result, checks = run(tiny_bench, cell, trace)
    assert result["correct"] and result["failed"] == 0, checks
    if trace:
        assert result["device"]["window_s"] > 0 and "breakdown" in result
        assert result["attempted"] == 2


def faults_of(cell: str) -> list:
    return [altered, stale] + ([half_batch] if cell == "tiny.b3" else [])


@pytest.mark.parametrize("limits_of, cell, fault", [
    (of, cell, f) for of, cell in LIMITS_ON for f in faults_of(cell)],
    ids=lambda v: getattr(v, "__name__", str(v)))
def test_fault_is_not_correct(tmp_path, monkeypatch, limits_of, cell, fault):
    limits = TINY_LIMITS if limits_of is None else json.loads(
        (BENCH / "limits" / f"{limits_of}.json").read_text())
    bench = make_tiny_bench(tmp_path, limits)
    if limits_of is not None:  # a sound run passes these limits at the tiny size
        sound, checks = run(bench, cell)
        assert sound["correct"], checks
    entry = ENTRY_FN[cell]
    monkeypatch.setattr(rt, entry, fault(getattr(rt, entry)))
    result, checks = run(bench, cell)
    assert not result["correct"], checks
    assert any(c["value"] > c["limit"] for c in checks.values())
