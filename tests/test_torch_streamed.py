"""The port's streamed two-pass tier (restore_file_streamed) on the CPU:
against the port's in-memory path (same length, atol 1e-5, the JAX tier's
own contract, tests/test_streaming_e2e.py:48-64), against the JAX streamed
tier by the compacted-sample rule, flutter, the auto route, and the
checkpoint sidecar: crash and resume, a replaced input, and a sidecar
written by the JAX package resumed by the port."""

import os
import time

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.pipelines import respeeder_device as rj
from pyaudiorestoration_tpu.utils import audio_io
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import audio_io as port_io

torch.set_num_threads(2)

SR, F0 = 8000, 1000.0
KW = dict(f0_hz=F0, fft_size=1024, fft_overlap=4, zeropad=1, sinc_quality=16)
CKW = dict(fft_size=1024, fft_overlap=8, zeropad=2, sinc_quality=16)


def _write_long_tone(path, seconds=8.0, channels=2, sr=SR, rate=1.5):
    """test_streaming_e2e.py's take, written in one-second chunks."""
    n = int(seconds * sr)
    with audio_io.StreamWriter(path, sr, channels) as w:
        phase = 0.0
        for start in range(0, n, sr):
            t = np.arange(start, min(n, start + sr)) / sr
            inc = 2 * np.pi * F0 * (1.0 + 0.01 * np.sin(2 * np.pi * rate * t)) / sr
            ph = phase + np.cumsum(inc)
            phase = ph[-1]
            block = 0.5 * np.sin(ph).astype(np.float32)
            w.write(np.stack([block * (1.0 - 0.3 * c) for c in range(channels)], -1))
    return path


def _flutter(x):
    s = np.sign(x)
    idx = np.nonzero((s[:-1] < 0) & (s[1:] >= 0))[0]
    fr = x[idx + 1] - x[idx]
    sub = idx - x[idx] / np.where(fr == 0, 1, fr)
    per = np.diff(sub)
    per = per[per > 1]
    return np.std(per) / np.mean(per)


def _assert_compacted_close(a, b):
    assert abs(len(a) - len(b)) <= 2
    m = min(len(a), len(b)) - 100
    err = np.abs(a[100:m] - b[100:m])
    assert np.median(err) < 1e-4, np.median(err)
    assert (err > 1e-2).mean() < 0.01


@pytest.fixture(scope="module")
def long_take(tmp_path_factory):
    return _write_long_tone(str(tmp_path_factory.mktemp("streamed") / "long.wav"))


def test_streamed_matches_in_memory(long_take):
    out_mem = rt.restore_file_fast(long_take, suffix="_mem", stream=False, device="cpu",
                                   **KW)
    timings = {}
    # tiny blocks and tiles force many pass-1 spans and pass-2 windows
    out_str = rt.restore_file_streamed(long_take, suffix="_str", frames_per_block=37,
                                       seg_tile=41, timings=timings, device="cpu", **KW)
    a, sr_a, _ = audio_io.read_file(out_mem)
    b, sr_b, _ = audio_io.read_file(out_str)
    assert sr_a == sr_b == SR
    assert a.shape == b.shape  # identical plan => identical output length
    np.testing.assert_allclose(a, b, atol=1e-5)
    for key in ("pass1_s", "pass1_read_s", "pass1_device_s", "plan_s", "pass2_s",
                "pass2_read_s", "pass2_device_dl_s", "pass2_write_s"):
        assert timings[key] >= 0.0, key
    assert (timings["n"], timings["sr"], timings["n_out"]) == (8 * SR, SR, len(b))


def test_streamed_matches_jax_streamed(long_take):
    out_t = rt.restore_file_streamed(long_take, suffix="_pt", frames_per_block=37,
                                     seg_tile=41, device="cpu", **KW)
    out_j = rj.restore_file_streamed(long_take, suffix="_pj", frames_per_block=37,
                                     seg_tile=41, **KW)
    a, _, ch = audio_io.read_file(out_t)
    b, _, _ = audio_io.read_file(out_j)
    assert a.shape == b.shape and ch == 2
    for c in range(ch):
        _assert_compacted_close(a[:, c], b[:, c])


def test_streamed_reduces_flutter(tmp_path):
    path = _write_long_tone(str(tmp_path / "long2.wav"), seconds=6.0, channels=1)
    out = rt.restore_file_streamed(path, frames_per_block=512, seg_tile=512,
                                   device="cpu", **KW)
    x, _, _ = audio_io.read_file(path)
    y, _, _ = audio_io.read_file(out)
    assert _flutter(y[:, 0]) < _flutter(x[:, 0]) / 3


def test_auto_threshold_routes_to_streamed(tmp_path, monkeypatch):
    path = _write_long_tone(str(tmp_path / "short.wav"), seconds=2.0, channels=1)
    calls = {}
    real = rt.restore_file_streamed

    def spy(*a, **k):
        calls["streamed"] = k
        return real(*a, **k)

    monkeypatch.setattr(rt, "restore_file_streamed", spy)
    out = rt.restore_file_fast(path, stream="auto", stream_threshold_bytes=1024,
                               device="cpu", **KW)
    assert calls.get("streamed") is not None
    assert len(audio_io.read_file(out)[0]) > 0


def _single_tone(sr, rate):
    n = 6 * sr
    t = np.arange(n) / sr
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * rate * t)
    return np.sin(2 * np.pi * 1000 * np.cumsum(speed) / sr).astype(np.float32)[:, None]


class _Boom(Exception):
    pass


def _crash_on_write(monkeypatch):
    for io in (audio_io, port_io):  # the JAX package's writer and the port's
        monkeypatch.setattr(io.StreamWriter, "write",
                            lambda self, block: (_ for _ in ()).throw(_Boom()))


def test_checkpoint_crash_and_resume(tmp_path, monkeypatch):
    """Pass 1's curve persists to the sidecar; a crash in pass 2 leaves it,
    the rerun resumes without re-tracking and gives run 1's output; success
    removes it (test_streaming_tools.py:231-275)."""
    p = str(tmp_path / "take.wav")
    audio_io.write_wav(p, _single_tone(16000, 1.5), 16000)
    out1 = rt.restore_file_streamed(p, device="cpu", **CKW)
    a, _, _ = audio_io.read_file(out1)
    assert not os.path.exists(str(tmp_path / "take_res.speeds.npz"))
    with monkeypatch.context() as m:
        _crash_on_write(m)
        with pytest.raises(_Boom):
            rt.restore_file_streamed(p, suffix="_r", device="cpu", **CKW)
    ckpt = str(tmp_path / "take_res_r.speeds.npz")
    assert os.path.exists(ckpt)
    with monkeypatch.context() as m:
        m.setattr(rt, "track_peaks_span", lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("tracking must not rerun when resuming")))
        out3 = rt.restore_file_streamed(p, suffix="_r", device="cpu", **CKW)
    assert not os.path.exists(ckpt)
    np.testing.assert_allclose(audio_io.read_file(out3)[0], a, atol=1e-6)


def test_checkpoint_rejects_replaced_input(tmp_path, monkeypatch):
    """A sidecar left by a crashed run is not resumed once the input has been
    replaced by another take of the same geometry
    (test_streaming_tools.py:445-501)."""
    p = str(tmp_path / "swap.wav")
    audio_io.write_wav(p, _single_tone(16000, 1.5), 16000)
    with monkeypatch.context() as m:
        _crash_on_write(m)
        with pytest.raises(_Boom):
            rt.restore_file_streamed(p, device="cpu", **CKW)
    assert os.path.exists(str(tmp_path / "swap_res.speeds.npz"))
    audio_io.write_wav(p, _single_tone(16000, 3.1), 16000)
    os.utime(p, ns=(time.time_ns() + 10**9, time.time_ns() + 10**9))
    tracked = {}
    real = rt.track_peaks_span

    def spy(*a, **k):
        tracked["ran"] = True
        return real(*a, **k)

    monkeypatch.setattr(rt, "track_peaks_span", spy)
    out = rt.restore_file_streamed(p, device="cpu", **CKW)
    assert tracked.get("ran"), "a stale sidecar was resumed for a replaced input"
    ref = rt.restore_file_streamed(p, suffix="_ref", device="cpu", **CKW)
    np.testing.assert_allclose(audio_io.read_file(out)[0], audio_io.read_file(ref)[0],
                               atol=1e-6)


def test_jax_sidecar_resumes_in_the_port(tmp_path, monkeypatch):
    """A sidecar written by the JAX package's crashed run resumes in the port
    without tracking, and gives the port's output for that speed curve."""
    p = str(tmp_path / "x.wav")
    audio_io.write_wav(p, np.repeat(_single_tone(16000, 1.5), 2, axis=1), 16000)
    with monkeypatch.context() as m:
        _crash_on_write(m)
        with pytest.raises(_Boom):
            rj.restore_file_streamed(p, **CKW)
    ckpt = str(tmp_path / "x_res.speeds.npz")
    ck = np.load(ckpt)
    assert ck["key"].dtype == np.int64 and ck["key"].shape == (11,)
    speeds = np.array(ck["speeds"])
    with monkeypatch.context() as m:
        m.setattr(rt, "track_peaks_span", lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("tracking must not rerun when resuming")))
        out = rt.restore_file_streamed(p, device="cpu", **CKW)
    assert not os.path.exists(ckpt)
    ref = rt.restore_file_streamed(p, suffix="_curve", speed_curve=speeds, device="cpu",
                                   **CKW)
    a, _, ch = audio_io.read_file(out)
    assert ch == 2
    np.testing.assert_allclose(a, audio_io.read_file(ref)[0], atol=1e-6)


def test_port_sidecar_resumes_in_jax(tmp_path, monkeypatch):
    p = str(tmp_path / "y.wav")
    audio_io.write_wav(p, _single_tone(16000, 1.5), 16000)
    with monkeypatch.context() as m:
        _crash_on_write(m)
        with pytest.raises(_Boom):
            rt.restore_file_streamed(p, device="cpu", **CKW)
    ckpt = str(tmp_path / "y_res.speeds.npz")
    assert os.path.exists(ckpt)
    with monkeypatch.context() as m:
        m.setattr(rj, "track_peaks_span", lambda *a, **k: (_ for _ in ()).throw(
            AssertionError("tracking must not rerun when resuming")))
        rj.restore_file_streamed(p, **CKW)
    assert not os.path.exists(ckpt)


def test_speed_curve_length_is_checked(long_take):
    with pytest.raises(ValueError, match="speed_curve"):
        rt.restore_file_streamed(long_take, speed_curve=np.ones(5), device="cpu", **KW)
