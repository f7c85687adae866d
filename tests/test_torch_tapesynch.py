"""The port's tapesync against the JAX package on the CPU: ``find_delay`` /
``find_delay_batch`` delays within 1e-3 samples and correlations within
1e-5; ``estimate_speed_ratio`` within 1e-6 relative; ``auto_align``'s lags
within 1e-3 samples (the known-shift case of
tests/test_host_loop_removal.py:48, and a 5 % fast source); ``align_files``
stage by stage (JAX's lag curve through the port's ``resampling.run`` gives
JAX's file within 3e-5); the CLI end to end; ``.tapesync`` projects read by
either package."""

import json

import numpy as np
import pytest
import scipy.signal as dsp
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.models import markers as mk_j
from pyaudiorestoration_tpu.ops import correlation as cj
from pyaudiorestoration_tpu.pipelines import tapesynch as tj
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu.utils import project as pj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.models import markers as mk_t
from pyaudiorestoration_tpu_torch.ops import correlation as ct
from pyaudiorestoration_tpu_torch.ops import resampling as rt
from pyaudiorestoration_tpu_torch.pipelines import tapesynch as tt
from pyaudiorestoration_tpu_torch.utils import audio_io as at
from pyaudiorestoration_tpu_torch.utils import project as pt

torch.set_num_threads(2)
SR = 8000
SHIFT = 480  # 60 ms


def _brown(n, seed=11):
    base = np.cumsum(np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
    base -= base.mean()
    return base / np.abs(base).max()


def _pair(fast=False, seconds=6, shift=SHIFT):
    """tests/test_host_loop_removal.py:48's reference and source: the source
    is the reference ``shift`` samples early, and with ``fast`` also played
    5 % fast."""
    n = SR * seconds
    base = _brown(n + SR)
    ref = base[:n]
    src = base[shift:shift + n]
    if fast:
        src = dsp.resample_poly(base[shift:], 20, 21)[:int(n / 1.05)].astype(np.float32)
    return ref[:, None], src[:, None]


@pytest.mark.parametrize("window_name", [None, "hann"])
@pytest.mark.parametrize("ignore_phase", [False, True])
def test_find_delay_matches_jax(window_name, ignore_phase):
    rng = np.random.default_rng(3)
    sig = rng.standard_normal((5, 1200)).astype(np.float32)
    shifts = [0, 7, -13, 40, 3]
    a = sig
    b = np.stack([np.roll(s, k) * (-1 if ignore_phase and i == 1 else 1)
                  for i, (s, k) in enumerate(zip(sig, shifts))]).astype(np.float32)
    kw = dict(ignore_phase=ignore_phase, window_name=window_name)
    dj, cj_ = cj.find_delay_batch(a, b, **kw)
    dt_, ct_ = ct.find_delay_batch(a, b, device="cpu", **kw)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), atol=1e-3)
    np.testing.assert_allclose(ct_.numpy(), np.asarray(cj_), atol=1e-5)
    for i in (0, 2):
        d1, c1 = ct.find_delay(torch.from_numpy(a[i]), torch.from_numpy(b[i]), **kw)
        d0, c0 = cj.find_delay(a[i], b[i], **kw)
        assert abs(float(d1) - float(d0)) <= 1e-3 and abs(float(c1) - float(c0)) <= 1e-5


def test_signal_helpers_equal():
    ref, src = _pair()
    for t0, t1 in ((-0.2, 0.5), (1.0, 2.5), (5.8, 6.4)):
        np.testing.assert_array_equal(tt.get_signal(ref, SR, t0, t1),
                                      tj.get_signal(ref, SR, t0, t1))
        np.testing.assert_array_equal(tt._fixed_window(src, SR, t0, 999),
                                      tj._fixed_window(src, SR, t0, 999))
    starts = [-0.1, 1.234, 5.9]
    got = tt._fixed_windows_device(torch.from_numpy(ref[:, 0]), SR, starts, 2000)
    want = np.stack([tj._fixed_window(ref, SR, s, 2000) for s in starts])
    np.testing.assert_array_equal(got.numpy(), want)
    lag_data = np.stack([np.linspace(0, 6, 300), 0.01 * np.sin(np.linspace(0, 6, 300))], -1)
    assert tt.get_speed_at(lag_data, 50.0, 2.0) == tj.get_speed_at(lag_data, 50.0, 2.0)


def test_estimate_speed_ratio_matches_jax():
    ref, src = _pair(fast=True)
    got = tt.estimate_speed_ratio(ref, src, SR, device="cpu")
    want = tj.estimate_speed_ratio(ref, src, SR)
    assert got == pytest.approx(want, rel=1e-6)
    assert got == pytest.approx(1.05, abs=0.01)


@pytest.mark.parametrize("fast", [False, True])
def test_auto_align_matches_jax(fast):
    """The lags equal JAX's within 1e-3 samples at ratio 1.  With a speed
    ratio r the port divides each window's measured delay by r where JAX
    multiplies (ROADMAP queue 3): the port's correction is JAX's over r**2,
    and the port's lags meet the true lag where JAX's miss it by
    D (r - 1/r) for a source D early."""
    ref, src = _pair(fast)
    kw = dict(num_windows=6, window_s=0.5, lower=50.0, match_speed=fast)
    s_j, curve_j = tj.auto_align(ref, src, SR, **kw)
    s_t, curve_t = tt.auto_align(ref, src, SR, device="cpu", **kw)
    assert len(s_t) == len(s_j) == 6
    t = np.array([s.t for s in s_t])
    r = tt.estimate_speed_ratio(ref, src, SR, device="cpu") if fast else 1.0
    guess = t - t / r
    d_t, d_j = np.array([s.d for s in s_t]), np.array([s.d for s in s_j])
    np.testing.assert_allclose(d_t - guess, (d_j - guess) / r ** 2, atol=1e-3 / SR)
    np.testing.assert_allclose([s.corr for s in s_t], [s.corr for s in s_j], atol=1e-5)
    truth = t - (t - SHIFT / SR) / (1.05 if fast else 1.0)
    np.testing.assert_allclose(d_t, truth, atol=2e-4)
    if fast:
        miss = SHIFT / SR * (1.05 - 1 / 1.05)  # 5.8 ms
        np.testing.assert_allclose(d_j - truth, miss, atol=5e-4)
    else:
        np.testing.assert_allclose(curve_t, curve_j, atol=1e-3 / SR)
    assert all(s.corr > 0.8 for s in s_t)


def test_auto_align_falls_back_per_window_on_a_data_fault(monkeypatch):
    ref, src = _pair()

    def broken(*a, **k):
        raise ValueError("degenerate window")

    monkeypatch.setattr(tt.correlation, "find_delay_batch", broken)
    samples, _ = tt.auto_align(ref, src, SR, num_windows=4, window_s=0.5, lower=50.0,
                               match_speed=False, device="cpu")
    np.testing.assert_allclose([s.d for s in samples], SHIFT / SR, atol=2e-4)


@pytest.mark.parametrize("fault", [tt.KernelError("sinc_banded_f32 kernel launch failed"),
                                   RuntimeError("CUDA error: an illegal memory access")])
def test_auto_align_raises_device_faults(monkeypatch, fault):
    ref, src = _pair()

    def broken(*a, **k):
        raise fault

    monkeypatch.setattr(tt.correlation, "find_delay_batch", broken)
    with pytest.raises(type(fault)):
        tt.auto_align(ref, src, SR, num_windows=4, window_s=0.5, lower=50.0,
                      match_speed=False, device="cpu")


@pytest.mark.parametrize("speed", [1.0, 1.05])
def test_correlate_sources_and_improve_lag_match_jax(speed):
    ref, src = _pair(fast=speed != 1.0)
    args = (ref, src, SR, 2.0, 3.0, SHIFT / SR, 100.0, 2000.0)
    got = tt.correlate_sources(*args, window_name="hann", speed=speed, device="cpu")
    want = tj.correlate_sources(*args, window_name="hann", speed=speed)
    # JAX multiplies the measured delay by the speed, the port divides
    assert abs(got[0] - want[0] / speed ** 2) <= 1e-3 / SR
    assert abs(got[1] - want[1]) <= 1e-5
    lags_t = [mk_t.LagSample((1.0, 100.0), (2.0, 2000.0), 0.05)]
    lags_j = [mk_j.LagSample((1.0, 100.0), (2.0, 2000.0), 0.05)]
    tt.improve_lag(ref, src, SR, lags_t, device="cpu")
    tj.improve_lag(ref, src, SR, lags_j)
    assert abs(lags_t[0].d - lags_j[0].d) <= 1e-3 / SR
    assert abs(lags_t[0].corr - lags_j[0].corr) <= 1e-5


def test_azimuth_sweep_matches_jax():
    """tests/test_pipelines.py:60's case."""
    sig = (np.random.default_rng(1234).standard_normal(4 * SR) * 0.3).astype(np.float32)
    src = np.roll(sig, 40)
    lag_data = np.stack([np.linspace(0, 4, 100), np.zeros(100)], axis=-1)
    args = (sig, src, SR, 0.5, 3.5, 100, 3000, lag_data)
    kw = dict(dur=0.25, overlap=2, reject=0.2)
    got = tt.azimuth_sweep(*args, device="cpu", **kw)
    want = tj.azimuth_sweep(*args, **kw)
    np.testing.assert_allclose(got.lags, want.lags, atol=1e-3 / SR)
    np.testing.assert_allclose(got.corrs, want.corrs, atol=1e-5)
    assert np.median(np.abs(got.lags + 0.005)) < 5e-4
    assert tt.azimuth_sweep(sig, src, SR, 3.5, 3.5, 100, 3000, lag_data, device="cpu") is None


def _files(tmp_path):
    """A 5 % fast source with no delay, where the port and JAX agree (see
    test_auto_align_matches_jax)."""
    ref, src = _pair(fast=True, shift=0)
    r, s = str(tmp_path / "ref.wav"), str(tmp_path / "src.wav")
    at.write_wav(r, np.repeat(ref, 2, 1), SR)
    at.write_wav(s, np.concatenate([src, 0.5 * src], 1), SR)
    return r, s


def test_align_files_stage_by_stage(tmp_path):
    """JAX's lag curve through the port's resampling.run gives JAX's file."""
    r, s = _files(tmp_path)
    paths_j, samples_j, curve_j = tj.align_files(r, s, out_suffix="_j", num_windows=6,
                                                 window_s=0.5, sinc_quality=20)
    src_sig, sr, _ = at.read_file(s)
    paths_t = rt.run((s,), signal_data=((src_sig, sr),), lag_curve=curve_j,
                     resampling_mode="Sinc", sinc_quality=20, suffix="_t", device="cpu")
    got, want = at.read_file(paths_t[0])[0], aj.read_file(paths_j[0])[0]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3e-5)


def test_tapesync_cli_and_projects_match_jax(tmp_path, capsys):
    r, s = _files(tmp_path)
    args = ["--windows", "6", "--window-s", "0.5", "--sinc-quality", "20",
            "--save-project"]
    assert cli_j.main(["tapesync", r, s, *args, "--suffix", "_j"]) in (0, None)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    proj_j = pj.Project.load(s[:-4] + ".tapesync")
    assert cli_t.main(["tapesync", r, s, *args, "--suffix", "_t", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lags_t, lags_j = np.array(got["lags"]), np.array(ref["lags"])
    np.testing.assert_array_equal(lags_t[:, :4], lags_j[:, :4])
    np.testing.assert_allclose(lags_t[:, 5], lags_j[:, 5], atol=1e-5)  # correlation
    # the delays, with the port's division by the ratio where JAX multiplies
    t = (lags_t[:, 0] + lags_t[:, 2]) / 2
    ref_sig, src_sig = at.read_file(r)[0], at.read_file(s)[0]
    ratio = tt.estimate_speed_ratio(ref_sig, src_sig, SR, device="cpu")
    guess = t - t / ratio
    np.testing.assert_allclose(lags_t[:, 4] - guess, (lags_j[:, 4] - guess) / ratio ** 2,
                               atol=1e-3 / SR)
    a, b = at.read_file(got["outputs"][0])[0], aj.read_file(ref["outputs"][0])[0]
    assert a.shape == b.shape and a.shape[1] == 2
    # between the first and last window centres the lag curves differ by
    # under 0.1 sample (past them the cubic spline extrapolates the
    # difference), so the outputs agree within a tenth of the largest step
    # between neighbouring samples
    span = slice(int(t[0] * SR), int(t[-1] * SR))
    np.testing.assert_allclose(a[span], b[span],
                               atol=0.1 * np.abs(np.diff(src_sig, axis=0)).max())
    # each package reads the other's .tapesync project, and replays it
    proj_t = pt.Project.load(s[:-4] + ".tapesync")
    for P in (pt.Project, pj.Project):
        for proj in (P.load(s[:-4] + ".tapesync"),):
            assert proj.settings["reference"] == r and proj.settings["source"] == s
    assert len(proj_t.marker_list("lags")) == len(proj_j.marker_list("lags")) == 6
    assert cli_t.main(["tapesync", s[:-4] + ".tapesync", "--windows", "6", "--window-s",
                       "0.5", "--sinc-quality", "20", "--suffix", "_p", "--device",
                       "cpu"]) == 0
    replay = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_array_equal(at.read_file(replay["outputs"][0])[0], a)


def test_tapesync_compare_is_not_ported(tmp_path, capsys):
    """``--compare``: a ``.html`` target gets the interactive overlay of the
    reference against the aligned output, anything else the matplotlib
    figure (where matplotlib is present)."""
    r, s = _files(tmp_path)
    for target in ("c.html", "c.png"):
        if target.endswith(".png"):
            pytest.importorskip("matplotlib")
        path = str(tmp_path / target)
        assert cli_t.main(["tapesync", r, s, "--windows", "6", "--window-s", "0.5",
                           "--sinc-quality", "20", "--compare", path, "--device",
                           "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["compare"] == path and out["outputs"] == [s[:-4] + "_res.wav"]
        with open(path, "rb") as f:
            head = f.read(8)
        assert head == (b"<!DOCTYP" if target == "c.html" else b"\x89PNG\r\n\x1a\n")


def test_cuda_default_raises_without_a_card(tmp_path):
    r, s = _files(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tt.align_files(r, s)
    ref, src = _pair()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tt.auto_align(ref, src, SR)
