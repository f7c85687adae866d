"""The streamed cell ``reel192.stream12m`` at a tiny size on the CPU.

``tiny.s3`` is ``tiny.f3``'s file, routed to the program's streamed tier by
a small ``stream_threshold_bytes``, with the tier's block and tile
defaults patched small, so that a call runs 5 pass-1 blocks and 5 pass-2
tiles: it runs through the harness ``correct`` against the file path's
plain reference (``FileReference``) under the cell's own limits file, and
fails them with one tile's anchors one sample off, one tile dropped or one
tile written twice.  A call that took the in-memory branch is a failed
call.  The cell's four readers read the program's spans and counters on
synthetic traces and are silent where those are absent."""

import inspect
import json
import math
import time
from types import SimpleNamespace

import pytest
from conftest import BENCH, TINY_FILE_TRAFFIC, add_tiny_cell, make_tiny_file_bench

from benchmark.lib import harness
from benchmark.lib import trace as tr
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import audio_io, timing

CELL = "reel192.stream12m"
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "stream12m.json").read_text())
SEED = 2 ** 31 + 97531
BLOCK, TILE = 128, 128
FRAMES = round(TINY_FILE_TRAFFIC["take_seconds"][0] * 22050) // 128 + 1  # 517 frames
TILES = math.ceil((FRAMES - 1) / TILE)


def tiny_streamed_bench(tmp_path, monkeypatch, limits=LIMITS, threshold=1024, **traffic):
    """The tiny file benchmark with the cell ``tiny.s3``: the ``tiny.f3``
    take through the ``file_streamed`` entry, the tiny configuration
    stating a ``threshold`` and the patched tier defaults."""
    bench, spec = make_tiny_file_bench(tmp_path)
    cfg_path = bench / "configs" / "tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(stream_threshold_bytes=threshold, frames_per_block=BLOCK, seg_tile=TILE)
    cfg_path.write_text(json.dumps(cfg))
    body = {**TINY_FILE_TRAFFIC, "entry": TRAFFIC["entry"], "pipeline": TRAFFIC["pipeline"],
            **traffic}
    add_tiny_cell(bench, spec, "s3", body, limits)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    names = [n for n, p in inspect.signature(rt.restore_file_streamed).parameters.items()
             if p.default is not inspect.Parameter.empty]
    defaults = list(rt.restore_file_streamed.__defaults__)
    defaults[names.index("frames_per_block")] = BLOCK
    defaults[names.index("seg_tile")] = TILE
    monkeypatch.setattr(rt.restore_file_streamed, "__defaults__", tuple(defaults))
    return bench, spec


def run(bench_spec, trace=False):
    bench, spec = bench_spec
    result, checks, _ = harness.run_cell("tiny.s3", SEED, 0.5, trace, t0=time.perf_counter(),
                                         bench_dir=bench, device="cpu", spec=spec)
    return result, checks


def test_the_cell_runs_the_streamed_tier():
    """The traffic and configuration the cell measures: the file pipeline
    through the streamed entry, one 12-minute 192 kHz stereo take past the
    1 GiB threshold, at the tier's defaults."""
    c = harness.cell_files(BENCH, harness.load_json(BENCH.parent / "BENCHMARK.json"), CELL)
    assert (c.traffic["entry"], c.traffic["pipeline"]) == ("file_streamed", "file_fast")
    frames = c.traffic["take_seconds"][0] * c.cfg["sample_rate"]
    assert frames * c.cfg["channels"] * 4 > c.cfg["stream_threshold_bytes"] == 1 << 30
    defaults = inspect.signature(rt.restore_file_streamed).parameters
    assert all(c.cfg[k] == defaults[k].default for k in c.entry.TIER_KEYS)


def test_sound_streamed_run_is_correct(tmp_path, monkeypatch):
    before = timing.counters()
    result, checks = run(tiny_streamed_bench(tmp_path, monkeypatch))
    assert result["correct"] and result["failed"] == 0, checks
    after = timing.counters()
    calls = after["respeeder.streamed"] - before.get("respeeder.streamed", 0)
    assert calls == result["attempted"] + TINY_FILE_TRAFFIC["warm_calls"]
    assert after["respeeder.tiles"] - before.get("respeeder.tiles", 0) == TILES * calls >= 3
    assert after["respeeder.blocks"] - before.get("respeeder.blocks", 0) == math.ceil(
        FRAMES / BLOCK) * calls


def test_traced_streamed_run_reads_its_metrics(tmp_path, monkeypatch):
    timing.reset_counters()
    result, checks = run(tiny_streamed_bench(tmp_path, monkeypatch), trace=True)
    assert result["correct"], checks
    m = result["metrics"]
    for metric in ("read_ms_per_call", "write_ms_per_call", "tile_ms_per_call",
                   "track_ms_per_call"):
        assert m[metric]["value"] > 0, metric
    assert "track_launches_per_call" in m  # no CUDA launch on the CPU: 0
    assert m["tiles_per_call"] == {"value": float(TILES), "unit": "tiles/call"}
    assert not {"plan_ms_per_call", "uploads_per_call", "downloads_per_call"} & set(m)


def anchors_off_by_one(monkeypatch):
    """Every anchor of each call's 2nd tile one input sample on (its
    ``base_int`` + 1); the tile count restarts each time the tier opens its
    writer."""
    state = {"tile": 0}
    sinc, opener = rt.run_banded_sinc, audio_io.open_writer

    def shifted(sig, speeds, n, base_int, *rest):
        state["tile"] += 1
        return sinc(sig, speeds, n, base_int + int(state["tile"] == 2), *rest)

    def opening(*a, **k):
        state["tile"] = 0
        return opener(*a, **k)

    monkeypatch.setattr(rt, "run_banded_sinc", shifted)
    monkeypatch.setattr(audio_io, "open_writer", opening)


class _Writer:
    """The tier's writer with its 2nd append dropped (``times`` 0) or
    written twice (``times`` 2)."""

    def __init__(self, writer, times):
        self.writer, self.times, self.appends = writer, times, 0

    def write(self, block):
        self.appends += 1
        for _ in range(self.times if self.appends == 2 else 1):
            self.writer.write(block)

    def close(self):
        self.writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _writes(times):
    def install(monkeypatch):
        opener = audio_io.open_writer
        monkeypatch.setattr(audio_io, "open_writer",
                            lambda *a, **k: _Writer(opener(*a, **k), times))
    return install


FAULTS = {"anchors_off_by_one": anchors_off_by_one, "tile_dropped": _writes(0),
          "tile_written_twice": _writes(2)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_streamed_fault_is_not_correct(tmp_path, monkeypatch, fault):
    bench = tiny_streamed_bench(tmp_path, monkeypatch)
    FAULTS[fault](monkeypatch)
    result, checks = run(bench)
    assert result["failed"] == 0 and not result["correct"], checks
    assert any(c["limit"] < c["value"] < float("inf") for c in checks.values())


def test_in_memory_call_is_a_failed_call(tmp_path, monkeypatch):
    """The window's first call is kept in memory by the router: the entry
    raises, so the harness counts it failed and the run is not correct; a
    warm call that the router keeps in memory (a threshold above the take's
    size) stops the run."""
    bench = tiny_streamed_bench(tmp_path, monkeypatch, warm_calls=0)
    should_stream, routed = rt.streaming.should_stream, []

    def first_in_memory(*a, **k):
        routed.append(bool(routed) and should_stream(*a, **k))
        return routed[-1]

    monkeypatch.setattr(rt.streaming, "should_stream", first_in_memory)
    result, checks = run(bench)
    assert routed[0] is False and all(routed[1:]) and len(routed) == result["attempted"] > 1
    assert result["failed"] == 1 and not result["correct"], checks
    monkeypatch.undo()
    bench = tiny_streamed_bench(tmp_path / "warm", monkeypatch, threshold=1 << 30)
    with pytest.raises(harness.CellError, match="restore_file_streamed"):
        run(bench)


def test_other_tier_defaults_cannot_run(tmp_path, monkeypatch):
    bench, spec = tiny_streamed_bench(tmp_path, monkeypatch)
    monkeypatch.setattr(rt.restore_file_streamed, "__defaults__",
                        tuple(d * 2 if d == TILE else d
                              for d in rt.restore_file_streamed.__defaults__))
    with pytest.raises(harness.CellError, match="default"):
        run((bench, spec))


# ---------------------------------------------------------------- readers

def read(metric, run_):
    return harness.load_module(BENCH, "metrics", metric).read(run_)


def synthetic_trace(calls=2, program_spans=True):
    """``calls`` calls in a 10,000 us window, 5,000 us apart.  A call's
    spans: read 0-300, track 300-700, read 700-800, host plan 800-900,
    tile 900-1,400 (K1's sinc inside), write 1,400-1,500, read 1,500-1,600,
    tile 1,600-2,000, write 2,000-2,200 and the close 2,200-2,250."""
    host = []
    for c in range(calls):
        t = 100 + c * 5000
        host += [(tr.CALL_SPAN, t, t + 2400), ("cudaLaunchKernel", t + 950, t + 960)]
        if program_spans:
            host += [("respeeder.read", t, t + 300), ("respeeder.track", t + 300, t + 700),
                     ("respeeder.read", t + 700, t + 800),
                     ("respeeder.host_plan", t + 800, t + 900),
                     ("respeeder.tile", t + 900, t + 1400),
                     ("respeeder.sinc", t + 1000, t + 1100),
                     ("respeeder.write", t + 1400, t + 1500),
                     ("respeeder.read", t + 1500, t + 1600),
                     ("respeeder.tile", t + 1600, t + 2000),
                     ("respeeder.write", t + 2000, t + 2200),
                     ("respeeder.write", t + 2200, t + 2250)]
    device = [("void sinc_banded_kernel<(Window)1, (Grids)0>(Args, int)", 1100, 1200)]
    return tr.Trace(device=device, host=host, window=(0, 10_000), calls=calls)


@pytest.mark.parametrize("metric,want", [("read_ms_per_call", 0.5),
                                         ("write_ms_per_call", 0.35),
                                         ("tile_ms_per_call", 0.9)])
def test_span_reader_on_a_synthetic_trace(metric, want):
    assert read(metric, SimpleNamespace(trace=synthetic_trace())) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["read_ms_per_call", "write_ms_per_call",
                                    "tile_ms_per_call"])
def test_span_reader_silent_without_the_spans(metric):
    assert read(metric, SimpleNamespace(trace=synthetic_trace(program_spans=False))) is None
    assert read(metric, SimpleNamespace(trace=None)) is None


def test_tiles_per_call_reads_the_program_counters(monkeypatch):
    monkeypatch.setattr(timing, "_counts", {})
    run_ = SimpleNamespace(trace=None)
    assert read("tiles_per_call", run_) is None  # no streamed call yet
    timing.count("respeeder.calls", 3)  # fused calls do not count
    timing.count("respeeder.streamed", 4)
    assert read("tiles_per_call", run_) is None  # no tile counter
    timing.count("respeeder.tiles", 68)
    assert read("tiles_per_call", run_) == 17.0
    monkeypatch.delattr(timing, "counters")  # a program without counters
    assert read("tiles_per_call", run_) is None
