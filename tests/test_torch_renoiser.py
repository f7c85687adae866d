"""The port's renoiser against the JAX package on the CPU: the gain mask
(at most 1e-4 of bins flipped, a bin within an ulp of its threshold may
flip), the noise profiles within 1e-3 dB (a noise file at the take's rate
and at another, resampled through ``resample_ratio``'s banded branch in
both packages), ``process`` within 1e-5 with each bin's threshold in a gap
of its levels (elsewhere a flipped bin moves the output by up to its
magnitude), ``process_file`` within 1e-5, the blockwise ``process`` within
1e-4 of the whole take in the interior (tests/test_streaming_tools.py:
278-289), the streamed file within 2e-7 of the in-memory one in the
interior (tests/test_streaming_tools.py:50-62), ``sniff_offset`` at JAX's
index, ``RenoisePreview``, and the ``renoise`` CLI (``--preview`` writes
its before/after figure where matplotlib is present)."""

import json

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.ops import fourier as fj
from pyaudiorestoration_tpu.ops import units as uj
from pyaudiorestoration_tpu.pipelines import renoiser as rj
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.ops import resampling as rs
from pyaudiorestoration_tpu_torch.pipelines import renoiser as rt
from pyaudiorestoration_tpu_torch.utils import audio_io as at
from tests.test_torch_cli_errors import error_exit

torch.set_num_threads(2)
SR = 22050


def _noisy_tone(n, seed=1, sr=SR):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    sig = np.sin(2 * np.pi * 880 * t) * 0.4 + rng.standard_normal(n) * 0.01
    return np.stack([sig, 0.6 * sig], -1).astype(np.float32)


def _write(path, x, sr=SR):
    at.write_wav(str(path), x, sr)
    return str(path)


def test_mask_fac_matches_jax():
    """The mask direction of tests/test_pipelines.py:265-272, and the mask of
    a real spectrogram: at most 1e-4 of bins flipped."""
    rng = np.random.default_rng(2)
    spec = np.abs(rng.standard_normal((10, 20))).astype(np.float32) + 0.5
    for level, want in ((10.0, 10 ** (-20 / 20)), (1e-6, 1.0)):
        fac = rt.get_mask_fac(spec, uj.to_dB(np.full(10, level)), -20.0, device="cpu")
        np.testing.assert_allclose(fac.numpy(), want, rtol=1e-5)
    x = _noisy_tone(2 * SR)[:, 0]
    mag = np.asarray(fj.get_mag(x, 1024, 256))
    profile = np.mean(uj.to_dB(mag), axis=1) + 3.0
    got = rt.get_mask_fac(mag, profile, -30.0, device="cpu").numpy()
    ref = np.asarray(rj.get_mask_fac(mag, profile, -30.0))
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.mean(got != ref) <= 1e-4
    assert 0.2 < np.mean(got < 1) < 0.9


def test_profiles_match_jax():
    rng = np.random.default_rng(3)
    mag = np.abs(rng.standard_normal((513, 200))).astype(np.float32) + 1e-3
    for t0, t1 in ((0.5, 1.5), (0.0, 100.0)):
        np.testing.assert_allclose(rt.noise_profile_from_selection(mag, SR, 256, t0, t1),
                                   rj.noise_profile_from_selection(mag, SR, 256, t0, t1),
                                   rtol=1e-6)
        got = rt.noise_profile_from_selection(torch.from_numpy(mag), SR, 256, t0, t1)
        np.testing.assert_array_equal(
            got, rt.noise_profile_from_selection(mag, SR, 256, t0, t1))
    freqs = np.arange(513) / 1024 * SR
    prof = rng.standard_normal(513) - 60
    for curve in ((), [(5000.0, 3.0), (100.0, -2.0), (9000.0, 1.0)]):
        np.testing.assert_array_equal(rt.final_profile(prof, freqs, curve, 1.0, 2.0),
                                      rj.final_profile(prof, freqs, curve, 1.0, 2.0))


def _banded_noise_length(noise_sr, seconds=1.5):
    """A noise length whose resampled output ends in a block of 400 samples,
    so JAX's banded check, which counts the padded tail, also takes the
    banded branch (ROADMAP queue 3)."""
    ratio = noise_sr / SR
    k = int(seconds * SR) // 512
    return int(round((512 * k + 400) * ratio))


@pytest.mark.parametrize("noise_sr", [SR, 24000])
def test_noise_profile_from_file_matches_jax(tmp_path, noise_sr):
    n = _banded_noise_length(noise_sr)
    rng = np.random.default_rng(4)
    noise = (rng.standard_normal((n, 2)) * 0.05).astype(np.float32)
    path = _write(tmp_path / "noise.wav", noise, noise_sr)
    got = rt.noise_profile_from_file(path, SR, 1024, 4, device="cpu")
    ref = rj.noise_profile_from_file(path, SR, 1024, 4)
    assert got.shape == ref.shape == (513,)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    if noise_sr != SR:
        pos = np.arange(int(round(n * SR / noise_sr))) * (noise_sr / SR)
        assert rs.banded_layout(pos, np.ones(len(pos), np.float32)) is not None


def _gap_profile(x, fft_size, hop, margin_db=0.01):
    """A threshold per bin in a gap of that bin's dB levels (over every
    frame and channel of ``x``) near their median, at least ``margin_db``
    from any level, so no bin can flip between two float32 FFTs."""
    padded = np.asarray(fj.fix_length(x, len(x) + fft_size // 2, axis=0))
    db = np.concatenate([uj.to_dB(np.abs(np.asarray(fj.stft(padded[:, c], fft_size, hop)))
                                  + 1e-7) for c in range(x.shape[1])], axis=1)
    prof = np.empty(db.shape[0], np.float32)
    for f, row in enumerate(np.sort(db, axis=1)):
        gaps = np.flatnonzero(np.diff(row) > 2 * margin_db)
        i = gaps[np.argmin(np.abs(gaps - len(row) // 2))]
        prof[f] = (row[i] + row[i + 1]) / 2
    return prof


@pytest.mark.parametrize("channels", [None, [1]])
def test_process_matches_jax(channels):
    x = _noisy_tone(int(2.5 * SR), seed=5)
    prof = _gap_profile(x, 1024, 256)
    got = rt.process(x, SR, prof, -30.0, 1024, 4, channels, device="cpu")
    ref = rj.process(x, SR, prof, -30.0, 1024, 4, channels)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got - x[:, channels or [0, 1]]).max() > 1e-3  # bins were masked


def test_process_blockwise_matches_whole():
    """tests/test_streaming_tools.py:278-289 on the port, and JAX's blockwise."""
    x = _noisy_tone(int(4.0 * SR), seed=21)
    prof = np.full((513,), -60.0, np.float32)
    a = rt.process(x, SR, prof, -30.0, 1024, 4, device="cpu")
    b = rt.process(x, SR, prof, -30.0, 1024, 4, blockwise=64, device="cpu")
    c = rj.process(x, SR, prof, -30.0, 1024, 4, blockwise=64)
    assert a.shape == b.shape == c.shape
    h = 8192
    np.testing.assert_allclose(a[h:-h], b[h:-h], atol=1e-4)
    np.testing.assert_allclose(b, c, atol=1e-5)


@pytest.mark.parametrize("source", ["selection", "noise"])
def test_process_file_matches_jax_and_streams(tmp_path, source):
    x = _noisy_tone(int(5.3 * SR))
    path = _write(tmp_path / "take.wav", x)
    kw = dict(gain=-30.0, fft_size=1024, fft_overlap=4)
    if source == "selection":
        kw["selection"] = (1.0, 2.0)
    else:
        kw["noise_path"] = _write(tmp_path / "n.wav", _noisy_tone(SR, seed=9) * 0.02)
        kw["control_curve"] = [(500.0, 6.0), (8000.0, 0.0)]
    timings = {}
    mem = at.read_file(rt.process_file(path, suffix="_m", stream=False, device="cpu",
                                       timings=timings, **kw))[0]
    assert list(timings) == ["read_s", "profile_s", "upload_s", "stft_s", "mask_s",
                             "istft_s", "download_s", "write_s"]
    got = at.read_file(rt.process_file(path, suffix="_s", stream=True, device="cpu",
                                       **kw))[0]
    ref = aj.read_file(rj.process_file(path, suffix="_j", stream=False, **kw))[0]
    assert got.shape == mem.shape == ref.shape == x.shape
    np.testing.assert_allclose(mem, ref, atol=1e-5)
    np.testing.assert_allclose(got[1024:-1024], mem[1024:-1024], atol=2e-7)


@pytest.mark.parametrize("seed,fft_size", [(0, 1024), (1, 512)])
def test_sniff_offset_matches_jax(seed, fft_size):
    """Clicks every 700 samples on a hiss floor: a clear hop phase."""
    rng = np.random.default_rng(seed)
    n = int(2.0 * SR)
    x = (rng.standard_normal(n) * 0.01).astype(np.float32)
    x[137::700] += 0.8
    got = rt.sniff_offset(x, SR, fft_size, 4, device="cpu")
    assert got == rj.sniff_offset(x, SR, fft_size, 4)
    assert got == rt.sniff_offset(np.stack([x, x], -1), SR, fft_size, 4, device="cpu")
    assert 0 <= got < fft_size // 4


def test_band_gain_positions_matches_a_loop():
    rng = np.random.default_rng(6)
    xp = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    got = rt._band_gain_positions(xp, 256, 10, 40, 1000, 300)
    w = torch.from_numpy(fj.get_window("blackmanharris", 256))
    for p in (0, 299, 300, 999):
        spec = torch.fft.rfft(xp[p:p + 256] * w) / 16.0
        assert torch.allclose(got[p], spec[10:40].abs().mean(), rtol=1e-6)


def test_preview_matches_jax():
    x = _noisy_tone(int(2.0 * SR), seed=7)
    pv_t = rt.RenoisePreview(x, SR, 1024, 4, device="cpu")
    pv_j = rj.RenoisePreview(x, SR, 1024, 4)
    np.testing.assert_allclose(pv_t.magnitude(), pv_j.magnitude(), rtol=1e-5, atol=1e-6)
    prof = pv_t.noise_profile_from_selection(0.2, 1.0)
    np.testing.assert_allclose(prof, pv_j.noise_profile_from_selection(0.2, 1.0),
                               atol=1e-3)
    kw = dict(control_curve=[(1000.0, 3.0)], overhead=2.0)
    a, b = pv_t.remask(prof, -20.0, **kw), pv_j.remask(prof, -20.0, **kw)
    assert np.mean(np.abs(a - b) > 1e-5 * np.abs(b).max()) <= 1e-4
    np.testing.assert_allclose(pv_t.render(prof, -20.0, **kw),
                               pv_j.render(prof, -20.0, **kw), atol=1e-5)


@pytest.mark.parametrize("extra", [["--selection", "1.0", "2.0"],
                                   ["--selection", "0.5", "1.5", "--gain", "-20",
                                    "--overhead", "3", "--stream"],
                                   ["--noise", "{noise}", "--fft-size", "512"]])
def test_renoise_cli_matches_jax(tmp_path, capsys, extra):
    path = _write(tmp_path / "r.wav", _noisy_tone(int(3.0 * SR), seed=8))
    noise = _write(tmp_path / "n.wav", _noisy_tone(SR, seed=9) * 0.02)
    extra = [a.format(noise=noise) for a in extra]
    assert cli_j.main(["renoise", path, *extra, "--suffix", "_j"]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert cli_t.main(["renoise", path, *extra, "--suffix", "_t", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert got[0].endswith("r_t.wav")
    np.testing.assert_allclose(at.read_file(got[0])[0], aj.read_file(ref[0])[0], atol=1e-5)


def test_renoise_preview_is_not_ported(tmp_path, capsys):
    """``--preview`` writes the figure (``--selection`` and ``--noise``), and
    needs one of them: without, both CLIs exit 1 with the same error line."""
    pytest.importorskip("matplotlib")
    path = _write(tmp_path / "r.wav", _noisy_tone(SR))
    noise = _write(tmp_path / "n.wav", _noisy_tone(SR // 2, seed=9) * 0.02)
    for i, src in enumerate([["--selection", "0.1", "0.5"], ["--noise", noise]]):
        png = str(tmp_path / f"p{i}.png")
        rc = cli_t.main(["renoise", path, *src, "--preview", png, "--device", "cpu"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 0 and out == {"preview": png}
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    argv = ["renoise", path, "--preview", png]
    want = error_exit(cli_j.main, argv, capsys)
    assert want == (1, ["error: preview needs --noise or --selection"])
    assert error_exit(cli_t.main, argv + ["--device", "cpu"], capsys) == want


def test_cuda_default_raises_without_a_card(tmp_path):
    path = _write(tmp_path / "r.wav", _noisy_tone(SR))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rt.process_file(path, selection=(0.1, 0.5))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rt.sniff_offset(np.zeros(4096, np.float32), SR)
