"""A cell's pipeline is found by name: the accepted cells take the default
``wow_flutter`` pipeline, which reads the same numbers as the pipeline
named outright; the file cell ``tiny.f3``, added as data files and a spec
entry only, runs from file to file through the program's
``restore_file_fast`` and is judged correct; and the file path's plain
reference plans and writes as the program does."""

import json
import time
import wave

import numpy as np
import pytest
import torch
from conftest import (BENCH, ROOT, TINY_TRAFFIC, make_tiny_bench, make_tiny_file_bench,
                      with_kept_aside)

from benchmark.lib import harness
from benchmark.pipelines import file_fast
from benchmark.reference.file_restore import file_plan
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import audio_io

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
ACCEPTED = ("tape192.take30", "cassette44.take240", "tape192.batch8", "tape192.side10m")
SEED = 2 ** 31 + 24680


def run(bench_spec, cell, trace=False, seed=SEED):
    bench, spec = bench_spec
    return harness.run_cell(cell, seed, 0.5, trace, t0=time.perf_counter(), bench_dir=bench,
                            device="cpu", spec=spec)


@pytest.mark.parametrize("cell", ACCEPTED)
def test_accepted_cells_take_the_default_pipeline(cell):
    c = harness.cell_files(BENCH, with_kept_aside(SPEC), cell)
    assert "pipeline" not in c.traffic
    assert c.pipeline.__name__ == f"benchmark.pipelines.{harness.DEFAULT_PIPELINE}"


@pytest.mark.parametrize("cell", ["tiny.t3", "tiny.b3"])
def test_default_pipeline_reads_as_the_named_one(tmp_path, cell):
    """A traffic file without the key and the same file naming
    ``wow_flutter`` give the same check numbers and counts, bit for bit."""
    default, named = (make_tiny_bench(tmp_path / side, {}) for side in ("default", "named"))
    traffic = named[0] / "traffic" / f"{cell.split('.')[1]}.json"
    traffic.write_text(json.dumps({**TINY_TRAFFIC[cell.split(".")[1]],
                                   "pipeline": harness.DEFAULT_PIPELINE}))
    (named[0] / "pipelines").symlink_to(BENCH / "pipelines")
    a, _, worst_a = run(default, cell)
    b, _, worst_b = run(named, cell)
    assert worst_a == worst_b and set(worst_a) == {"sample_gap", "residual_gap", "residual_rms",
                                                   "timing_gap"}
    assert a["failed"] == b["failed"] == 0


def test_file_cell_added_as_data_runs_correct(tmp_path):
    bench, spec = make_tiny_file_bench(tmp_path)
    assert sorted(p.name for p in (bench / "traffic").iterdir()) == ["b3.json", "f3.json",
                                                                      "t3.json"]
    assert all((bench / kind).is_symlink() for kind in ("entries", "metrics", "pipelines"))
    result, checks, worst = run((bench, spec), "tiny.f3")
    assert result["correct"] and result["failed"] == 0, checks
    assert set(result["metrics"]) == {"x_realtime", "setup_s"}
    assert worst["residual_rms"] < checks["residual_rms"]["limit"]
    assert not (tmp_path / "build" / "benchmark_files" / "tiny.f3").exists()


def test_traced_file_cell_reads_the_tracking(tmp_path):
    """The file path opens the tracking's span and no span of the fused
    entries; a traced run on the CPU reads the tracking and leaves the
    fused-only metrics out of the line."""
    result, checks, _ = run(make_tiny_file_bench(tmp_path), "tiny.f3", trace=True)
    assert result["correct"], checks
    m = result["metrics"]
    assert m["track_ms_per_call"]["value"] > 0
    assert not {"plan_ms_per_call", "program_idle_pct", "uploads_per_call",
                "download_ms_per_call", "downloads_per_call"} & set(m)


def test_pcm24_file_holds_the_take(tmp_path):
    """The set-up's writer: 24-bit little-endian PCM that the program's codec
    reads back as the integers over 2**23, bit for bit."""
    x = np.stack([np.linspace(-1.0, 1.0, 1001), np.sin(np.arange(1001.0))]).astype(np.float32)
    held = file_fast.write_pcm24(tmp_path / "t.wav", x, 22050)
    with wave.open(str(tmp_path / "t.wav")) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (2, 3, 22050)
    q = held.astype(np.float64) * 2 ** 23
    assert np.array_equal(q, np.round(q)) and q.max() == 2 ** 23 - 1 and q.min() == -2 ** 23
    assert np.max(np.abs(held - x)) <= 2.0 ** -23
    signal, sr, channels = audio_io.read_file(str(tmp_path / "t.wav"))
    assert (sr, channels) == (22050, 2) and np.array_equal(signal.T, held)


@pytest.mark.parametrize("n_in", [32 * 64, 32 * 64 + 5, 31 * 64 + 40])
def test_file_plan_is_the_program_host_plan(n_in):
    """The reference's float64 plan, with its exact advances, against the
    program's digamma plan: the same counts and trimmed length, and the same
    bases to rounding, on a wobbling curve and at the end trim."""
    frames = n_in // 64 + 1
    t = np.arange(frames)
    speeds = (1.0 + 0.01 * np.sin(t / 3.0) + 0.003 * np.cos(t * 1.7)).astype(np.float32)
    prog = rt.plan_positions_fast(speeds, 64, n_in)
    ref = file_plan(torch.as_tensor(speeds), 64, n_in)
    assert np.array_equal(prog["n"], ref["n"].numpy()) and prog["n_out"] == ref["n_out"]
    base = prog["base_int"].astype(np.float64) + prog["base_frac"]
    assert np.max(np.abs(base - ref["base"].numpy())) < 1e-5


def test_file_plan_trims_at_the_input_end():
    """At a constant speed of 1 every segment gives ``hop`` outputs one input
    sample apart; the last one, at the input's end, is the nearest to it and
    the stream stops before it."""
    hop, frames = 64, 33
    pl = file_plan(torch.ones(frames), hop, hop * (frames - 1))
    assert pl["n"].tolist() == [hop] * (frames - 1)
    assert pl["n_out"] == hop * (frames - 1) - 1
    assert torch.equal(pl["base"], torch.arange(frames - 1, dtype=torch.float64) * hop)
