"""The port's differential EQ against the JAX package on the CPU:
``get_eq`` within 1e-3 dB (at one rate and with a reference at another),
``shape_eq`` on the same curves equal to JAX's host numpy to float64
rounding, the three FilterCurve files and the ``difeq`` CLI within 1e-3 dB,
and the known-filter check of tests/test_pipelines.py:153-166."""

import json
import re

import numpy as np
import pytest
import scipy.signal as dsp
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.pipelines import difeq as dj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.pipelines import difeq as dt
from pyaudiorestoration_tpu_torch.utils import audio_io as at

torch.set_num_threads(2)
SR = 22050


def _pair(tmp_path, ref_sr=SR, seconds=3.0, seed=3, lowpass=False):
    """A noise reference and the source: the reference through a gentle
    FIR tilt (-8 dB at Nyquist), or with ``lowpass`` a 3rd-order Butterworth
    at 4 kHz.  The latter's zeros at Nyquist put the source's top bins at
    the float32 FFT's rounding floor, where two FFTs differ by tenths of a
    dB, so the parity tests use the tilt."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    ref = (rng.standard_normal((n, 2)) * 0.2).astype(np.float32)
    if lowpass:
        src = dsp.sosfilt(dsp.butter(3, 4000 / (SR / 2), output="sos"), ref, axis=0)
    else:
        src = dsp.lfilter([0.6, 0.3, 0.1], [1.0], ref, axis=0)
    src = src.astype(np.float32)
    if ref_sr != SR:
        ref = dsp.resample_poly(ref, ref_sr // 50, SR // 50, axis=0).astype(np.float32)
    p_ref, p_src = str(tmp_path / "ref.wav"), str(tmp_path / "src.wav")
    at.write_wav(p_ref, ref, ref_sr)
    at.write_wav(p_src, src, SR)
    return p_src, p_ref


@pytest.mark.parametrize("ref_sr", [SR, 24000])
@pytest.mark.parametrize("mode", ["L+R", "L"])
def test_get_eq_matches_jax(tmp_path, ref_sr, mode):
    p_src, p_ref = _pair(tmp_path, ref_sr)
    f_t, eq_t = dt.get_eq(p_src, p_ref, mode, fft_size=4096, hop=2048, device="cpu")
    f_j, eq_j = dj.get_eq(p_src, p_ref, mode, fft_size=4096, hop=2048)
    np.testing.assert_array_equal(f_t, f_j)
    assert eq_t.shape == eq_j.shape == (2, 2049)
    np.testing.assert_allclose(eq_t, eq_j, atol=1e-3)


@pytest.mark.parametrize("kw", [{}, {"keep_gain": True, "strength": 0.5},
                                {"highpass": 80.0, "rolloff_start": 9000,
                                 "rolloff_end": 10000, "smoothing": 20}])
def test_shape_eq_matches_jax(kw):
    rng = np.random.default_rng(4)
    freqs = np.arange(2049) / 4096 * SR
    eqs = [rng.standard_normal((2, 2049)) for _ in range(2)]
    fa, a = dt.shape_eq(freqs, eqs, **kw)
    fb, b = dj.shape_eq(freqs, eqs, **kw)
    np.testing.assert_allclose(fa, fb, rtol=1e-12)
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def _curve(path):
    text = open(path).read()
    assert text.startswith("FilterCurve:")
    return np.array([float(v) for v in re.findall(r'v\d+="([^"]+)"', text)])


def test_difeq_files_match_jax(tmp_path):
    p_src, p_ref = _pair(tmp_path)
    _, av_t, paths_t = dt.difeq_files(p_src, p_ref, str(tmp_path / "t"), device="cpu")
    _, av_j, paths_j = dj.difeq_files(p_src, p_ref, str(tmp_path / "j"))
    assert [p.rsplit("/", 1)[-1] for p in paths_t] == ["t.txt", "t_L.txt", "t_R.txt"]
    np.testing.assert_allclose(av_t, av_j, atol=1e-3)
    for a, b in zip(paths_t, paths_j):
        np.testing.assert_allclose(_curve(a), _curve(b), atol=1e-3)


def test_difeq_cli_matches_jax(tmp_path, capsys):
    p_src, p_ref = _pair(tmp_path)
    args = ["--smoothing", "30", "--highpass", "60", "--keep-gain"]
    assert cli_j.main(["difeq", p_src, p_ref, "-o", str(tmp_path / "j.txt"), *args]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert cli_t.main(["difeq", p_src, p_ref, "-o", str(tmp_path / "t.txt"), *args,
                       "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_curve(a), _curve(b), atol=1e-3)


def test_difeq_detects_known_filter(tmp_path):
    """tests/test_pipelines.py:153-166 on the port: src = lowpassed ref, so
    the EQ curve boosts the highs (ref - src > 0)."""
    p_src, p_ref = _pair(tmp_path, lowpass=True)
    freqs, eq = dt.get_eq(p_src, p_ref, "L+R", device="cpu")
    hi = (freqs > 8000) & (freqs < 10000)
    lo = (freqs > 100) & (freqs < 2000)
    assert np.mean(eq[0][hi]) > np.mean(eq[0][lo]) + 20
