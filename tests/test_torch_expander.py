"""The port's spectral expander against the JAX package on the CPU: the
band envelopes within 1e-3 dB for every channel mode, ``expand`` within
1e-5 (with and without the high/low split), ``expand_file`` in memory
within 1e-5 of JAX's and streamed within 2e-4 of the port's in-memory file
in the interior (tests/test_streaming_tools.py:177-199) and 1e-5 of JAX's
streamed file; the gain law of tests/test_pipelines.py:173-202; the
``expand`` CLI against JAX's."""

import json

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.pipelines import expander as ej
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.pipelines import expander as et
from pyaudiorestoration_tpu_torch.utils import audio_io as at

torch.set_num_threads(2)
SR = 22050
KW = dict(fft_size=512, band_lower=8000, band_upper=10000)


def _hissy(tmp_path, seconds=3.0, seed=11, name="h.wav"):
    """A tone with a hiss band whose level steps at 0.4 Hz
    (tests/test_streaming_tools.py:177-199's signal at 22.05 kHz)."""
    n = int(seconds * SR)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    amp = 0.02 + 0.3 * (np.sin(2 * np.pi * 0.4 * t) > 0)
    sig = np.sin(2 * np.pi * 9000 * t) * amp + rng.standard_normal(n) * 0.003
    x = np.stack([sig, 0.8 * sig], -1).astype(np.float32)
    path = str(tmp_path / name)
    at.write_wav(path, x, SR)
    return path, x


@pytest.mark.parametrize("mode", ["L+R", "L", "R", "Mean"])
def test_envelope_curves_match_jax(tmp_path, mode):
    path, _ = _hissy(tmp_path)
    t_t, curves_t, sr_t = et.envelope_curves(path, mode, device="cpu", **KW)
    t_j, curves_j, sr_j = ej.envelope_curves(path, mode, **KW)
    assert sr_t == sr_j and len(curves_t) == len(curves_j)
    np.testing.assert_array_equal(t_t, t_j)
    for a, b in zip(curves_t, curves_j):
        np.testing.assert_allclose(a, b, atol=1e-3)


@pytest.mark.parametrize("transition", [0, 6000])
def test_expand_matches_jax(tmp_path, transition):
    path, x = _hissy(tmp_path)
    t, curves, _ = ej.envelope_curves(path, "L+R", **KW)
    kw = dict(clip_lower=-60, clip_upper=-25, transition=transition, order=1)
    got = et.expand(x, SR, t, curves, device="cpu", **kw)
    ref = ej.expand(x, SR, t, curves, **kw)
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got).max() == pytest.approx(1.0)


def test_expand_file_matches_jax_and_streams(tmp_path):
    path, x = _hissy(tmp_path)
    kw = dict(channel_mode="L+R", clip_lower=-60, clip_upper=-25, transition=6000, **KW)
    timings = {}
    mem = at.read_file(et.expand_file(path, suffix="_m", stream=False, device="cpu",
                                      timings=timings, **kw))[0]
    assert list(timings) == ["read_s", "spectra_s", "band_download_s", "envelope_s",
                             "reread_s", "host_gain_s", "upload_s", "gain_s", "download_s",
                             "write_s"]
    got = at.read_file(et.expand_file(path, suffix="_s", stream=True, device="cpu",
                                      **kw))[0]
    ref = aj.read_file(ej.expand_file(path, suffix="_jm", stream=False, **kw))[0]
    ref_s = aj.read_file(ej.expand_file(path, suffix="_js", stream=True, **kw))[0]
    assert got.shape == mem.shape == ref.shape == x.shape
    np.testing.assert_allclose(mem, ref, atol=1e-5)
    h = 4096
    np.testing.assert_allclose(got[h:-h], mem[h:-h], atol=2e-4)
    np.testing.assert_allclose(got, ref_s, atol=1e-5)


def test_expander_gain_law(tmp_path):
    """tests/test_pipelines.py:173-202 on the port: a section whose hiss
    band is 6 dB lower is boosted 6 dB relative to the loud one."""
    sr = 44100
    n = 2 * sr
    t = np.arange(n) / sr
    env = 10 ** ((-6 + 3 * np.sign(np.sin(2 * np.pi * 1.0 * t))) / 20)
    sig = (np.sin(2 * np.pi * 15000 * t) * env * 0.5).astype(np.float32)
    src = str(tmp_path / "comp.wav")
    at.write_wav(src, sig, sr)
    tt, curves, _ = et.envelope_curves(src, channel_mode="L", band_lower=14000,
                                       band_upper=16000, device="cpu")
    lo, hi = float(np.percentile(curves[0], 15)), float(np.percentile(curves[0], 85))
    signal, _, _ = at.read_file(src)
    out = et.expand(signal, sr, tt, curves, clip_lower=lo, clip_upper=hi, device="cpu")

    def section_rms(x, center):
        s = slice(int((center - 0.1) * sr), int((center + 0.1) * sr))
        v = x[s, 0] if x.ndim == 2 else x[s]
        return np.sqrt(np.mean(v ** 2))

    ratio_db = 20 * np.log10((section_rms(out, 0.75) / section_rms(sig, 0.75))
                             / (section_rms(out, 0.25) / section_rms(sig, 0.25)))
    assert ratio_db == pytest.approx(6.0, abs=1.0), ratio_db


@pytest.mark.parametrize("extra", [[], ["--transition", "6000", "--stream"]])
def test_expand_cli_matches_jax(tmp_path, capsys, extra):
    path, _ = _hissy(tmp_path)
    args = ["--band-lower", "8000", "--band-upper", "10000", "--clip-lower", "-60",
            "--clip-upper", "-25", *extra]
    assert cli_j.main(["expand", path, *args, "--suffix", "_j"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert cli_t.main(["expand", path, *args, "--suffix", "_t", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert got[0].endswith("h_t.wav")
    np.testing.assert_allclose(at.read_file(got[0])[0], aj.read_file(ref[0])[0],
                               atol=1e-5)
