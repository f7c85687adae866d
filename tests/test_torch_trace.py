"""The program's spans and counters (``utils/timing.py``) on the fused
restoration, on the CPU: under ``torch.profiler`` each entry call records
one ``respeeder.call`` span holding its upload, tracking (one a take), plan
and sinc spans; with no profiler running no ``record_function`` is entered
and the output is bit-identical; ``respeeder.uploads`` counts the take,
each tracking chunk's window and DFT matrix and a batch's inverse limbs and
lengths; ``reset_counters`` zeroes the counters, and K1's and K2's launch
counts live in the same registry."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import timing

torch.set_num_threads(2)

# test_torch_fused.py's takes: a 1024 Hz tone at 8192 Hz
SR, NFFT, STEP, ZP, F0 = 8192, 512, 128, 1, 1024.0
F0_BIN = int(round(F0 * NFFT * ZP / SR))
BAND = (F0_BIN - 6, F0_BIN + 7)
MAX_N = int(STEP * 1.25)
LENGTHS = [3 * SR + 77, 2 * SR, 4 * SR]
SPANS = ("respeeder.call", "respeeder.upload", "respeeder.track", "respeeder.plan",
         "respeeder.sinc")


def _take(n, rate, phase=0.0, depth=0.012):
    t = np.arange(n) / SR
    speed = 1.0 + depth * np.sin(2 * np.pi * rate * t + phase)
    return np.sin(2 * np.pi * F0 * np.cumsum(speed) / SR).astype(np.float32)


def _call(entry, lengths=True, host_bands=False):
    """One call of ``entry`` ("single": a stereo take, "batch": 3 takes of
    mixed length) on host numpy input.  Returns (the call, its takes'
    lengths); the bands are CPU tensors, so on the CPU they are no upload,
    unless ``host_bands``."""
    if entry == "single":
        x = _take(3 * SR, 1.3)
        x = np.stack([x, 0.8 * x])
        frames = x.shape[1] // STEP + 1
        NL, NU = (torch.full((frames,), BAND[0] + d, dtype=torch.int32) for d in (2, 11))
        if host_bands:
            NL, NU = NL.numpy(), NU.numpy()
        return (lambda: rt.restore_fused_device(x, NL, NU, NFFT, STEP, ZP, MAX_N, 16, 16,
                                                band=BAND, device="cpu")), [x.shape[1]]
    xb = np.zeros((3, max(LENGTHS)), np.float32)
    for i, L in enumerate(LENGTHS):
        xb[i, :L] = _take(L, 1.0 + 0.7 * i, 0.3 * i)
    frames = xb.shape[1] // STEP + 1
    NL, NU = (torch.full((3, frames), BAND[0] + d, dtype=torch.int32) for d in (2, 11))
    return (lambda: rt.restore_fused_takes(
        xb, NL, NU, NFFT, STEP, ZP, MAX_N, 16, 16, band=BAND,
        lengths=LENGTHS if lengths else None, device="cpu")), [xb.shape[1]] * 3


def _spans(prof):
    """name -> [(start, end)] of the program's spans in a finished profile."""
    out = {}
    for e in prof.events():
        if e.name in SPANS:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


@pytest.mark.parametrize("entry,tracks", [("single", 1), ("batch", 3)])
def test_spans_nest_inside_one_call(entry, tracks):
    call, _ = _call(entry)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = _spans(prof)
    assert {k: len(v) for k, v in spans.items()} == {
        "respeeder.call": 1, "respeeder.upload": 1, "respeeder.track": tracks,
        "respeeder.plan": 1, "respeeder.sinc": 1}
    (lo, hi), = spans["respeeder.call"]
    inner = sorted((iv, name) for name in SPANS[1:] for iv in spans[name])
    assert [name for _, name in inner] == (["respeeder.upload"] + ["respeeder.track"] * tracks
                                           + ["respeeder.plan", "respeeder.sinc"])
    assert all(lo <= s <= e <= hi for (s, e), _ in inner)
    assert all(a[1] <= b[0] for (a, _), (b, _) in zip(inner, inner[1:]))  # one after another


@pytest.mark.parametrize("entry", ["single", "batch"])
def test_no_record_function_without_a_profiler(entry, monkeypatch):
    call, _ = _call(entry)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = call()

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert timing.span("respeeder.call") is timing.span("respeeder.plan")
    plain = call()
    assert torch.equal(plain, traced)


@pytest.mark.parametrize("entry,chunk_frames,lengths,host_bands", [
    ("single", 4096, True, False), ("single", 64, True, False), ("single", 4096, True, True),
    ("batch", 4096, True, False), ("batch", 64, True, False), ("batch", 64, False, False)])
def test_uploads_counted_at_their_sites(entry, chunk_frames, lengths, host_bands,
                                        monkeypatch):
    track = rt.track_peaks_span
    monkeypatch.setattr(rt, "track_peaks_span",
                        lambda *a: track(*a[:8], chunk_frames, *a[9:]))
    call, ns = _call(entry, lengths, host_bands)
    before = timing.counters()
    call()
    after = timing.counters()
    chunks = [-(-(n // STEP + 1) // chunk_frames) for n in ns]
    want = 1 + sum(2 * c for c in chunks) + 2 * host_bands
    if entry == "batch" and lengths:
        want += 2  # the inverse limbs and the lengths
    assert after["respeeder.uploads"] - before.get("respeeder.uploads", 0) == want
    assert after["respeeder.calls"] - before.get("respeeder.calls", 0) == 1


def test_reset_counters_zeroes_every_counter(monkeypatch):
    monkeypatch.setattr(timing, "_counts", {})
    timing.count("test.a", 3)
    timing.count("test.b")
    timing.count("k1.launches", 2)
    timing.count("k2.launches", 5)
    assert kb.launches() == (2, 5)
    kb.reset_launches()
    assert kb.launches() == (0, 0) and timing.counters()["test.a"] == 3
    timing.reset_counters("test.a")
    assert timing.counters() == {"test.a": 0, "test.b": 1, "k1.launches": 0, "k2.launches": 0}
    timing.reset_counters()
    assert set(timing.counters().values()) == {0}
    counters = timing.counters()
    counters["test.a"] = 7  # a copy: the registry is unchanged
    assert timing.counters()["test.a"] == 0
