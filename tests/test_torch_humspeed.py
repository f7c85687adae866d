"""The port's hum-based speed matching against the JAX package on the CPU:
the long-FFT spectrum within 1e-3 dB within 60 dB of its peak (its
centring pad longer than the signal), the hum matches at JAX's ratio, the
in-memory resample within 1e-5 of JAX's (both on ``resample_ratio``'s
banded branch: the take's length puts the last output block past JAX's
padded-tail limit, ROADMAP queue 3), the streamed resample at the same
pitch and within 5e-3 of the in-memory one after xcorr alignment
(tests/test_streaming_tools.py:354-390), and the ``humspeed`` CLI against
JAX's."""

import json

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.pipelines import humspeed as hj
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.ops import resampling as rs
from pyaudiorestoration_tpu_torch.pipelines import humspeed as ht
from pyaudiorestoration_tpu_torch.utils import audio_io as at

torch.set_num_threads(2)
SR = 22050
FFT = 2 ** 15


def _length(ratio, blocks=200, last=450):
    """Samples whose resample at ``ratio`` ends in a ``last``-sample block."""
    return int(round((512 * blocks + last) * ratio))


def _hum_take(tmp_path, n, fast=51.0 / 50.0, seed=0, name="hum.wav"):
    """Mains hum at 50 Hz and its harmonics recorded ``fast``, with a tone
    and noise, stereo."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    sig = (0.05 * np.sin(2 * np.pi * 50 * fast * t) + 0.05 * np.sin(2 * np.pi * 100 * fast * t)
           + 0.05 * np.sin(2 * np.pi * 150 * fast * t) + 0.3 * np.sin(2 * np.pi * 440 * fast * t)
           + 0.01 * rng.standard_normal(n))
    x = np.stack([sig, 0.7 * sig], -1).astype(np.float32)
    path = str(tmp_path / name)
    at.write_wav(path, x, SR)
    return path, x


@pytest.mark.parametrize("fft_size", [FFT, 2 ** 19])
def test_get_spectrum_matches_jax(tmp_path, fft_size):
    path, _ = _hum_take(tmp_path, 4 * SR)
    f_t, s_t, sr_t = ht.get_spectrum(path, "L+R", fft_size, device="cpu")
    f_j, s_j, sr_j = hj.get_spectrum(path, "L+R", fft_size)
    assert sr_t == sr_j and s_t.shape == s_j.shape == (fft_size // 2 + 1,)
    np.testing.assert_array_equal(f_t, f_j)
    # one or two frames: no mean smooths the deep bins' float32 FFT rounding
    # (test_torch_spectrum_flat.py's per-frame rule)
    loud = s_j > s_j.max() - 60
    np.testing.assert_allclose(s_t[loud], s_j[loud], atol=1e-3)
    peak = 10 ** (s_j.max() / 20)
    assert np.all(np.abs(10 ** (s_t / 20) - 10 ** (s_j / 20)) <= 1e-6 * peak)


@pytest.mark.parametrize("harmonies,tolerance", [(2, 8), (1, 3)])
def test_analyze_hum_matches_jax(tmp_path, harmonies, tolerance):
    path, _ = _hum_take(tmp_path, 5 * SR)
    kw = dict(base_hum=50, num_harmonies=harmonies, tolerance=tolerance, fft_size=FFT)
    got = ht.analyze_hum(path, device="cpu", **kw)
    ref = hj.analyze_hum(path, **kw)
    assert [m["target"] for m in got] == [m["target"] for m in ref] and len(got) >= 2
    for g, r in zip(got, ref):
        assert g["freq"] == pytest.approx(r["freq"], abs=1e-3)
        assert g["ratio"] == pytest.approx(r["ratio"], rel=1e-6)
        assert g["dB"] == pytest.approx(r["dB"], abs=1e-3)
    assert got[-1]["ratio"] == pytest.approx(50 / 51, abs=2e-3)


def test_track_to_matches_jax():
    rng = np.random.default_rng(1)
    spectrum = (rng.standard_normal(4097) - 60).astype(np.float32)
    spectrum[300] = -10.0
    spectrum[299] = -14.0
    freqs = np.arange(4097) / 8192 * 800
    for xpos in (29.0, 30.0, 31.0):
        got = ht.track_to(freqs, spectrum, 800, 8192, xpos, [30.0, 60.0], tolerance=8)
        ref = hj.track_to(freqs, spectrum, 800, 8192, xpos, [30.0, 60.0], tolerance=8)
        assert got is not None and ref is not None
        np.testing.assert_allclose(got, ref, rtol=1e-6)
    assert ht.track_to(freqs, spectrum, 800, 8192, 30.0, [60.0], tolerance=8) is None


def test_resample_file_matches_jax(tmp_path):
    ratio = 1.02
    path, x = _hum_take(tmp_path, _length(ratio))
    pos = np.arange(int(round(len(x) / ratio))) * ratio
    assert rs.banded_layout(pos, np.ones(len(pos), np.float32)) is not None
    timings = {}
    got = at.read_file(ht.resample_file(path, ratio=ratio, stream=False, device="cpu",
                                        timings=timings))[0]
    ref = aj.read_file(hj.resample_file(path, ratio=ratio, stream=False))[0]
    assert got.shape == ref.shape == (len(pos), 2)
    assert list(timings) == ["analyze_s", "read_s", "upload_s", "positions_s", "sinc_s",
                             "download_s", "write_s"]
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _pitch(y):
    x = y[:, 0].astype(np.float64)
    idx = np.where(np.bitwise_xor(x[1:] > 0, x[:-1] > 0))[0]
    cr = idx + x[idx] / (x[idx] - x[idx + 1])
    return SR / np.mean(np.diff(cr[len(cr) // 4: -len(cr) // 4])) / 2


def test_streamed_resample_matches_memory(tmp_path):
    """tests/test_streaming_tools.py:354-390 on the port."""
    n = int(4.0 * SR)
    t = np.arange(n) / SR
    sig = (np.sin(2 * np.pi * 440 * t) * 0.5).astype(np.float32)[:, None]
    path = str(tmp_path / "tone.wav")
    at.write_wav(path, sig, SR)
    ratio = 1.02
    a = at.read_file(ht.resample_file(path, ratio=ratio, stream=False, device="cpu"))[0]
    out_s = ht.resample_file(path, ratio=ratio, stream=True, device="cpu")
    assert out_s.endswith("tone_resampled_2.000.wav")
    b = at.read_file(out_s)[0]
    assert abs(len(a) - len(b)) < 1024
    for y in (a, b):
        assert abs(_pitch(y) - 440 * ratio) < 1.0
    h = 8192
    m = min(len(a), len(b)) - h
    xa, xb = a[h:m, 0], b[h:m, 0]
    k = int(np.argmax([np.dot(xa[64:4096], xb[64 + k:4096 + k])
                       for k in range(-64, 65)])) - 64
    np.testing.assert_allclose(xa[64:20000], xb[64 + k:20000 + k], atol=5e-3)


def test_humspeed_cli_matches_jax(tmp_path, capsys):
    path, x = _hum_take(tmp_path, _length(50 / 51, blocks=300), name="h.wav")
    args = ["--harmonies", "2", "--tolerance", "8"]
    assert cli_j.main(["humspeed", path, *args, "--analyze-only"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli_t.main(["humspeed", path, *args, "--analyze-only", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "outputs" not in got and len(got["matches"]) == len(ref["matches"]) >= 2
    for g, r in zip(got["matches"], ref["matches"]):
        assert g["ratio"] == pytest.approx(r["ratio"], rel=1e-6)
    assert cli_t.main(["humspeed", path, *args, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"][0]
    ratio = got["matches"][-1]["ratio"]
    want = aj.read_file(hj.resample_file(path, ratio=ratio, stream=False))[0]
    np.testing.assert_allclose(at.read_file(out)[0], want, atol=1e-5)


def test_cuda_default_raises_without_a_card(tmp_path):
    path, _ = _hum_take(tmp_path, SR)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ht.analyze_hum(path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ht.resample_file(path, ratio=1.01)
