"""The port's host I/O (``pyaudiorestoration_tpu_torch.utils``: its own copy of
the native codec, ``audio_io``, ``streaming`` and ``timing``) against the
JAX package's: the same bytes written, the same samples read."""

import logging

import numpy as np
import pytest

from pyaudiorestoration_tpu.utils import audio_io as ja
from pyaudiorestoration_tpu.utils import streaming as js
from pyaudiorestoration_tpu_torch.utils import audio_io as ta
from pyaudiorestoration_tpu_torch.utils import streaming as ts
from pyaudiorestoration_tpu_torch.utils import timing

SR = 22050


def _signal(frames=30011, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / SR
    x = 0.4 * np.sin(2 * np.pi * 440 * t)[:, None] + 0.2 * rng.standard_normal(
        (frames, channels))
    x[123:140] = 1.3  # clipped run
    return x.astype(np.float32)


WRITES = {
    "wav_float": lambda io, p, x: io.write_wav(p, x, SR),
    "wav_pcm16": lambda io, p, x: io.write_wav(p, x, SR, subtype="PCM_16"),
    "flac16_fast": lambda io, p, x: io.write_flac(p, x, SR, 16, 0),
    "flac16": lambda io, p, x: io.write_flac(p, x, SR, 16, 1),
    "flac24_fast": lambda io, p, x: io.write_flac(p, x, SR, 24, 0),
    "flac24": lambda io, p, x: io.write_flac(p, x, SR, 24, 1),
}


def _write_both(tmp_path, kind, x):
    ext = "flac" if kind.startswith("flac") else "wav"
    paths = []
    for name, io in (("jax", ja), ("port", ta)):
        paths.append(str(tmp_path / f"{name}_{kind}.{ext}"))
        WRITES[kind](io, paths[-1], x)
    return paths


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("kind", list(WRITES))
def test_writes_are_byte_equal(tmp_path, kind, channels):
    a, b = _write_both(tmp_path, kind, _signal(channels=channels))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("kind", list(WRITES))
def test_reads_are_equal(tmp_path, kind):
    path, _ = _write_both(tmp_path, kind, _signal())
    xj, srj, chj = ja.read_file(path)
    xt, srt, cht = ta.read_file(path)
    assert (srt, cht) == (srj, chj) == (SR, 2)
    assert xt.dtype == np.float32 and np.array_equal(xt, xj)
    assert ta.probe_file(path) == ja.probe_file(path)
    assert ts.decoded_bytes(path) == js.decoded_bytes(path) == xj.size * 4


@pytest.mark.parametrize("kind", ["wav_float", "wav_pcm16", "flac16", "flac24_fast"])
def test_stream_reader_blocks_are_equal(tmp_path, kind):
    path, _ = _write_both(tmp_path, kind, _signal(frames=50003))
    with ja.StreamReader(path) as rj, ta.StreamReader(path) as rt:
        assert (rt.sample_rate, rt.channels, rt.frames) == (rj.sample_rate, rj.channels,
                                                            rj.frames)
        for start, count in [(0, 4096), (4095, 1), (12345, 20000), (49000, 5000)]:
            assert np.array_equal(rt.read(start, count), rj.read(start, count))


@pytest.mark.parametrize("ext,bits,level", [("wav", None, None), ("flac", 16, 0),
                                            ("flac", 24, 1)])
def test_open_writer_streams_the_same_bytes(tmp_path, ext, bits, level):
    x = _signal(frames=20000)
    paths = []
    for name, io in (("jax", ja), ("port", ta)):
        paths.append(str(tmp_path / f"{name}.{ext}"))
        with io.open_writer(paths[-1], SR, 2, bits=bits, level=level) as w:
            for a in range(0, len(x), 7001):  # blocks that cut FLAC frames
                w.write(x[a:a + 7001])
    with open(paths[0], "rb") as fa, open(paths[1], "rb") as fb:
        assert fa.read() == fb.read()


def test_write_file_follows_the_output_format(tmp_path):
    x = _signal(frames=9000)
    src = str(tmp_path / "take.wav")
    try:
        assert ta.out_ext() == "wav"
        assert ta.write_file(src, x, SR, suffix="_a") == str(tmp_path / "take_a.wav")
        ta.set_output_format("flac", bits=16, level=0)
        ja.set_output_format("flac", bits=16, level=0)
        assert ta.out_ext() == "flac"
        out_t = ta.write_file(src, x, SR, suffix="_t")
        out_j = ja.write_file(src, x, SR, suffix="_j")
        assert out_t == str(tmp_path / "take_t.flac")
        with open(out_t, "rb") as ft, open(out_j, "rb") as fj:
            assert ft.read() == fj.read()
        with pytest.raises(ValueError):
            ta.set_output_format("flac", bits=20)
        with pytest.raises(ValueError):
            ta.set_output_format("mp3")
    finally:
        ta.set_output_format("wav")
        ja.set_output_format("wav")


def test_should_stream_and_blocks_match_the_jax_package(tmp_path):
    path, _ = _write_both(tmp_path, "wav_float", _signal(frames=4000))
    for stream in (True, False, "auto"):
        for threshold in (1, 1 << 30):
            assert (ts.should_stream(path, stream, threshold)
                    == js.should_stream(path, stream, threshold))
    for n, hop, blocksize, overlap in [(100_000, 128, 64, 8), (5000, 256, 4096, 32),
                                       (12_800, 128, 100, 0)]:
        assert (list(ts.iter_blocks(n, hop, blocksize, overlap))
                == list(js.iter_blocks(n, hop, blocksize, overlap)))
    sig = _signal(frames=40_000, channels=1)[:, 0]

    def tracker(block, sr):
        frames = len(block) // 128
        return np.arange(frames) * 128 / sr, block[:frames * 128:128] * 2.0

    for a, b in zip(ts.stream_trace(sig, SR, tracker, 512, 128, blocksize=50, overlap=8),
                    js.stream_trace(sig, SR, tracker, 512, 128, blocksize=50, overlap=8)):
        assert np.array_equal(a, b)


def test_log_duration_logs_the_stage(caplog):
    with caplog.at_level(logging.DEBUG):
        with timing.log_duration("Resampling"):
            pass
    messages = [r.getMessage() for r in caplog.records]
    assert messages[0] == "Resampling"
    assert messages[1].startswith("Resampling took ")


def test_port_builds_its_own_codec():
    so = ta.build()
    assert so.parent.name == "torch_native" and so.is_file()
    assert ta.build() == so  # the same source and flags: the same build
