"""The port's per-band group delay and cyclic wow analysis against the JAX
package on the CPU: ``band_delays`` lags within 1e-3 samples and the same
bands kept (the power-of-two ``n_fft`` kept, so the lags are JAX's), the
bands' responses on the device against scipy's ``sosfreqz``, the
constant-shift detection of tests/test_aux.py:154-163; ``cycle_average`` and
``find_cycle`` equal to JAX's, ``analyze``'s rpm within 1e-6 relative
(tests/test_aux.py:170-182's take); the ``group-delay`` and ``cyclic-wow``
CLIs against JAX's."""

import json

import numpy as np
import pytest
import torch
from scipy import signal as dsp

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.pipelines import cyclic_wow as cj
from pyaudiorestoration_tpu.pipelines import group_delay as gj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.pipelines import cyclic_wow as ct
from pyaudiorestoration_tpu_torch.pipelines import group_delay as gt
from pyaudiorestoration_tpu_torch.utils import audio_io as at

torch.set_num_threads(2)
SR = 8000


def _shifted(n, shift, seed=0):
    sig = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return sig, np.roll(sig, shift)


@pytest.mark.parametrize("n,shift,kw", [
    (4 * SR, 25, dict(f_lower=50, f_upper=2000, bandwidth=100, min_corr=0.5)),
    (3 * SR + 123, -7, dict(f_lower=100, f_upper=3000, bandwidth=150, order=2)),
])
def test_band_delays_match_jax(n, shift, kw):
    ref, src = _shifted(n, shift)
    got = gt.band_delays(ref, src, SR, device="cpu", **kw)
    want = gj.band_delays(ref, src, SR, **kw)
    assert [b["band_hz"] for b in got] == [b["band_hz"] for b in want] and len(got) >= 5
    for g, w in zip(got, want):
        assert g["lag_samples"] == pytest.approx(w["lag_samples"], abs=1e-3)
        assert g["corr"] == pytest.approx(w["corr"], abs=1e-5)
        assert g["ref_rms"] == pytest.approx(w["ref_rms"], rel=1e-5)
        assert g["src_rms"] == pytest.approx(w["src_rms"], rel=1e-5)
    assert np.median(np.abs(np.asarray([b["lag_samples"] for b in got]) + shift)) < 2


@pytest.mark.parametrize("order", [1, 2, 3])
def test_band_responses_match_sosfreqz(order):
    """The device's float64 |H|^2 against scipy's ``sosfreqz`` (JAX's host
    path): equal to a float32 ulp."""
    sr, n_fft = 44100, 1 << 14
    sos = [dsp.butter(order, [lo / (sr / 2), hi / (sr / 2)], btype="band", output="sos")
           for lo, hi in ((10, 20), (100, 150), (1500, 2000))]
    w = 2 * np.pi * np.fft.rfftfreq(n_fft, 1 / sr) / sr
    want = np.stack([np.abs(dsp.sosfreqz(s, worN=w)[1]) ** 2 for s in sos]).astype(np.float32)
    got = gt._band_responses(sos, n_fft, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-30)


def test_bandify_is_zero_phase_filtering():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    H = torch.ones((2, 1025))
    H[1, 100:] = 0.0
    out = gt._bandify(x, H, 1000, 2048)
    np.testing.assert_allclose(out[0].numpy(), x.numpy(), atol=1e-5)
    assert out.shape == (2, 1000)


def _record(seconds=8.0, sr=22050, rpm_true=44.0, f0=700.0):
    """tests/test_aux.py:170-182's transfer: a tone with 1 % wow at the
    rotation rate of a 44 rpm record."""
    t = np.arange(int(seconds * sr)) / sr
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * rpm_true / 60 * t)
    return np.sin(2 * np.pi * f0 * np.cumsum(speed) / sr).astype(np.float32)


def test_cycle_scan_matches_jax():
    rng = np.random.default_rng(2)
    curve = np.sin(np.arange(3000) * 2 * np.pi / 237) + 0.1 * rng.standard_normal(3000)
    for fpr in (200, 237, 4000):
        np.testing.assert_array_equal(ct.cycle_average(curve, fpr), cj.cycle_average(curve, fpr))
    got, want = ct.find_cycle(curve, 230, 0.1), cj.find_cycle(curve, 230, 0.1)
    assert got[:2] == want[:2] and abs(got[0] - 237) <= 1
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("stereo", [False, True])
def test_analyze_matches_jax(stereo):
    sig = _record()
    if stereo:
        sig = np.stack([sig, 0.5 * sig], -1)
    got = ct.analyze(sig, 22050, rpm=45.0, f0=700.0, fft_size=8192, device="cpu")
    want = cj.analyze(sig, 22050, rpm=45.0, f0=700.0, fft_size=8192)
    assert got["frames_per_rotation"] == want["frames_per_rotation"]
    assert got["actual_rpm"] == pytest.approx(want["actual_rpm"], rel=1e-6)
    assert got["actual_rpm"] == pytest.approx(44.0, rel=0.02)
    assert got["wow_depth_semitones"] == pytest.approx(want["wow_depth_semitones"],
                                                       rel=1e-3)
    np.testing.assert_allclose(got["cycle_curve"], want["cycle_curve"], atol=1e-5)


def test_group_delay_cli_matches_jax(tmp_path, capsys):
    ref, src = _shifted(3 * SR, 21, seed=3)
    pr, ps = str(tmp_path / "r.wav"), str(tmp_path / "s.wav")
    at.write_wav(pr, ref, SR)
    at.write_wav(ps, src, SR)
    args = ["--lower", "50", "--upper", "2000", "--bandwidth", "100"]
    assert cli_j.main(["group-delay", pr, ps, *args]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli_t.main(["group-delay", pr, ps, *args, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["sr"] == want["sr"] == SR and len(got["bands"]) == len(want["bands"]) >= 5
    for g, w in zip(got["bands"], want["bands"]):
        assert g["lag_samples"] == pytest.approx(w["lag_samples"], abs=1e-3)


def test_cyclic_wow_cli_matches_jax(tmp_path, capsys):
    path = str(tmp_path / "rec.wav")
    at.write_wav(path, _record(), 22050)
    args = ["--rpm", "45", "--fft-size", "8192"]
    assert cli_j.main(["cyclic-wow", path, *args, "--curve-out", str(tmp_path / "j.txt")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli_t.main(["cyclic-wow", path, *args, "--curve-out", str(tmp_path / "t.txt"),
                       "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(got) == sorted(want)
    assert got["frames_per_rotation"] == want["frames_per_rotation"]
    assert got["actual_rpm"] == pytest.approx(want["actual_rpm"], rel=1e-6)
    np.testing.assert_allclose(np.loadtxt(got["curve_out"]), np.loadtxt(want["curve_out"]),
                               atol=1e-4)


def test_cuda_default_raises_without_a_card():
    ref, src = _shifted(SR, 3)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        gt.band_delays(ref, src, SR)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ct.analyze(ref, SR)
