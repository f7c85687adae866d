"""The port's HPSS tool against the JAX package on the CPU: ``separate``
within 1e-5 of JAX's per-channel loop (margin 1 and 2, a channel subset),
the streamed file within 1e-5 of the port's in-memory file in the interior
(tests/test_streaming_tools.py:113-133), the tone/clicks separation of
tests/test_pipelines.py:279-296, and the ``hpss`` CLI against JAX's (its
``--stream`` against the port's in-memory CLI: JAX's streamed HPSS takes
~30 s to compile on the CPU)."""

import json

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.pipelines import hpss_tool as hj
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.pipelines import hpss_tool as ht
from pyaudiorestoration_tpu_torch.utils import audio_io as at

torch.set_num_threads(2)
SR = 22050


def _tone_clicks(seconds=2.0, every=2048):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = (np.sin(2 * np.pi * 440 * t) * 0.4).astype(np.float32)
    clicks = np.zeros(n, np.float32)
    clicks[::every] = 0.5
    return np.stack([sig + clicks, 0.5 * (sig + clicks)], -1), sig


@pytest.mark.parametrize("margin,channels", [(1.0, None), (2.0, [1])])
def test_separate_matches_jax(margin, channels):
    x, _ = _tone_clicks()
    got = ht.separate(x, SR, 1024, 4, kernel_size=17, margin=margin, channels=channels,
                      device="cpu")
    ref = hj.separate(x, SR, 1024, 4, kernel_size=17, margin=margin, channels=channels)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (len(x), 1 if channels else 2)
        np.testing.assert_allclose(g, r, atol=1e-5)
    if margin == 1.0:
        np.testing.assert_allclose(got[2], 0.0, atol=1e-5)
        np.testing.assert_allclose(got[0] + got[1], x, atol=1e-4)


def test_separate_file_streamed_matches_memory(tmp_path):
    x, _ = _tone_clicks(3.7)
    path = str(tmp_path / "tc.wav")
    at.write_wav(path, x, SR)
    timings = {}
    mem = ht.separate_file(path, 1024, 4, kernel_size=17, margin=2.0, suffix="_m",
                           stream=False, device="cpu", timings=timings)
    assert list(timings) == ["read_s", "upload_s", "stft_s", "hpss_s", "istft_s",
                             "download_s", "write_s"]
    assert all(v >= 0 for v in timings.values())
    got = ht.separate_file(path, 1024, 4, kernel_size=17, margin=2.0, suffix="_s",
                           stream=True, device="cpu")
    assert [p.rsplit("/", 1)[-1] for p in got] == ["tc_H_s.wav", "tc_P_s.wav", "tc_R_s.wav"]
    for pm, ps in zip(mem, got):
        a, b = at.read_file(pm)[0], at.read_file(ps)[0]
        assert a.shape == b.shape == x.shape
        np.testing.assert_allclose(b[2048:-2048], a[2048:-2048], atol=1e-5)


def test_hpss_separates_tone_from_clicks(tmp_path):
    """tests/test_pipelines.py:279-296 on the port."""
    n = 2 * SR
    tone = np.sin(2 * np.pi * 880 * np.arange(n) / SR) * 0.3
    clicks = np.zeros(n)
    clicks[::SR // 4] = 0.8
    src = str(tmp_path / "mix.wav")
    at.write_wav(src, (tone + clicks).astype(np.float32), SR)
    paths = ht.separate_file(src, fft_size=1024, fft_overlap=4, kernel_size=31,
                             device="cpu")
    H, P = at.read_file(paths[0])[0], at.read_file(paths[1])[0]
    assert np.corrcoef(H[:n, 0], tone)[0, 1] > 0.8
    click_idx = np.arange(SR // 4, n - 1, SR // 4)
    assert np.abs(P[click_idx, 0]).mean() > np.abs(H[click_idx, 0]).mean()


@pytest.mark.parametrize("extra", [[], ["--margin", "2"]])
def test_hpss_cli_matches_jax(tmp_path, capsys, extra):
    x, _ = _tone_clicks()
    path = str(tmp_path / "c.wav")
    at.write_wav(path, x, SR)
    args = ["--fft-size", "1024", "--kernel", "17", *extra]
    assert cli_j.main(["hpss", path, *args, "--suffix", "_j"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert cli_t.main(["hpss", path, *args, "--suffix", "_t", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert len(got) == len(ref) == (3 if extra else 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(at.read_file(g)[0], aj.read_file(r)[0], atol=1e-5)
    assert cli_t.main(["hpss", path, *args, "--suffix", "_s", "--stream", "--device",
                       "cpu"]) == 0
    streamed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert [p.replace("_s.", "_t.") for p in streamed] == got
    for g, s in zip(got, streamed):
        np.testing.assert_allclose(at.read_file(s)[0][2048:-2048],
                                   at.read_file(g)[0][2048:-2048], atol=1e-5)
