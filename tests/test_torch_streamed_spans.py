"""The spans and counters of the file paths (``utils/timing.py``) on the
CPU: the streamed tier (``restore_file_streamed``) counts one
``respeeder.streamed`` a call, a ``respeeder.blocks`` a pass-1 block and a
``respeeder.tiles`` a pass-2 tile, and under ``torch.profiler`` records its
read, track, host-plan, tile and write spans; with and without a profiler
it writes the same bytes; ``restore_file_fast``'s in-memory branch names
its read, host plan and write alike; the streamed output is the in-memory
path's, bit for bit."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import audio_io, timing

torch.set_num_threads(2)

SR, F0 = 8000, 1000.0
KW = dict(f0_hz=F0, fft_size=1024, fft_overlap=4, zeropad=1, sinc_quality=16)
HOP = 256
N = 4 * SR + 77
N_FRAMES = (N + 1024 - 1024) // HOP + 1  # 126 frames, 125 segments
BLOCK, TILE = 40, 40  # 4 pass-1 blocks, 4 pass-2 tiles
COUNTERS = ("respeeder.streamed", "respeeder.blocks", "respeeder.tiles")
STREAMED_SPANS = ("respeeder.read", "respeeder.track", "respeeder.host_plan",
                  "respeeder.tile", "respeeder.write", "respeeder.sinc")


@pytest.fixture(scope="module")
def take(tmp_path_factory):
    """A stereo tone with 1 % wow, written as a float32 WAV."""
    t = np.arange(N) / SR
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * 1.5 * t)
    x = 0.5 * np.sin(2 * np.pi * F0 * np.cumsum(speed) / SR).astype(np.float32)
    path = str(tmp_path_factory.mktemp("spans") / "take.wav")
    audio_io.write_wav(path, np.stack([x, 0.7 * x], -1), SR)
    return path


def _streamed(path, suffix):
    return rt.restore_file_streamed(path, suffix=suffix, frames_per_block=BLOCK,
                                    seg_tile=TILE, device="cpu", **KW)


def _span_counts(prof, names):
    counts = {}
    for e in prof.events():
        if e.name in names:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_counters_of_a_streamed_call(take):
    before = timing.counters()
    _streamed(take, "_count")
    after = timing.counters()
    moved = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}
    assert moved == {"respeeder.streamed": 1,
                     "respeeder.blocks": math.ceil(N_FRAMES / BLOCK),
                     "respeeder.tiles": math.ceil((N_FRAMES - 1) / TILE)}
    assert moved["respeeder.blocks"] >= 3 and moved["respeeder.tiles"] >= 3


def test_streamed_spans_under_the_profiler(take):
    """Each block's and tile's read (``f0_hz`` given: no probe), each block's
    tracking and the centring, one plan, each tile (K1's span inside) and
    each append plus the close."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _streamed(take, "_prof")
    blocks, tiles = math.ceil(N_FRAMES / BLOCK), math.ceil((N_FRAMES - 1) / TILE)
    assert _span_counts(prof, STREAMED_SPANS) == {
        "respeeder.read": blocks + tiles, "respeeder.track": blocks + 1,
        "respeeder.host_plan": 1, "respeeder.tile": tiles, "respeeder.write": tiles + 1,
        "respeeder.sinc": tiles}
    tile_spans = [e.time_range for e in prof.events() if e.name == "respeeder.tile"]
    for e in prof.events():
        if e.name == "respeeder.sinc":
            assert any(r.start <= e.time_range.start and e.time_range.end <= r.end
                       for r in tile_spans)


def test_streamed_bytes_with_and_without_a_profiler(take):
    plain = _bytes(_streamed(take, "_plain"))
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _bytes(_streamed(take, "_traced"))
    assert plain == traced


def test_in_memory_branch_names_its_host_work(take):
    before = timing.counters().get("respeeder.streamed", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = rt.restore_file_fast(take, suffix="_mem", stream=False, device="cpu", **KW)
    assert _span_counts(prof, STREAMED_SPANS) == {
        "respeeder.read": 1, "respeeder.host_plan": 1, "respeeder.write": 1,
        "respeeder.track": 1, "respeeder.sinc": 1}
    assert timing.counters().get("respeeder.streamed", 0) == before
    plain = rt.restore_file_fast(take, suffix="_mem2", stream=False, device="cpu", **KW)
    assert _bytes(out) == _bytes(plain)


def test_auto_route_counts_the_streamed_tier(take):
    """``restore_file_fast`` on a file past its threshold is one streamed call."""
    before = timing.counters().get("respeeder.streamed", 0)
    rt.restore_file_fast(take, suffix="_auto", stream="auto", stream_threshold_bytes=1024,
                         device="cpu", **KW)
    assert timing.counters()["respeeder.streamed"] == before + 1


@pytest.mark.parametrize("block,tile", [(BLOCK, TILE), (37, 41), (4096, 16384)])
def test_streamed_output_is_the_in_memory_one(take, block, tile):
    """Blocks and tiles cut at other places than the in-memory path's chunks
    give its output bit for bit: the same length and the same samples."""
    a, sr_a, _ = audio_io.read_file(rt.restore_file_fast(take, suffix="_m", stream=False,
                                                         device="cpu", **KW))
    b, sr_b, _ = audio_io.read_file(rt.restore_file_streamed(
        take, suffix=f"_s{block}", frames_per_block=block, seg_tile=tile, device="cpu", **KW))
    assert sr_a == sr_b == SR
    assert np.array_equal(a, b)
