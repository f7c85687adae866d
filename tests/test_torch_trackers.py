"""The port's trackers against the JAX package's on the CPU, each fed the
JAX package's own spectrum (a numpy array): equal times, frequencies
within rtol 2e-4 (tests/test_adaptive_tracking.py:63)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.models import trackers as tj
from pyaudiorestoration_tpu.ops import fourier as fj
from pyaudiorestoration_tpu_torch.models import trackers as tt

torch.set_num_threads(2)

SR, NFFT, ZEROPAD, HOP = 16000, 512, 2, 128


@pytest.fixture(scope="module")
def take():
    n = 3 * SR
    t = np.arange(n) / SR
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * 1.3 * t)
    phase = 2 * np.pi * 1500.0 * np.cumsum(speed) / SR
    rng = np.random.default_rng(0)
    x = (0.5 * np.sin(phase) + 1e-3 * rng.standard_normal(n)).astype(np.float32)
    spec = np.asarray(fj.get_mag(jnp.asarray(x), NFFT, HOP, zeropad=ZEROPAD))
    return x[:, None], spec


TRAIL = [(0.0, 1500.0), (3.0, 1500.0)]


@pytest.mark.parametrize("mode", sorted(tj.wow_detectors))
@pytest.mark.parametrize("trail", [TRAIL, [(0.3, 1480.0), (1.2, 1530.0), (2.5, 1500.0)]])
def test_every_mode_matches_jax(take, mode, trail):
    sig, spec = take
    args = (spec, sig, trail, NFFT * ZEROPAD, HOP, SR, 1.0, "None")
    t_ref, f_ref = tj.trace(mode, *args)
    t_got, f_got = tt.trace(mode, *args, device="cpu")
    assert np.array_equal(t_got, t_ref)
    np.testing.assert_allclose(f_got, f_ref, rtol=2e-4)


@pytest.mark.parametrize("mode", ["Constant", "Linear", "Average"])
def test_adaptive_peak_matches_jax(take, mode):
    sig, spec = take
    args = (spec, sig, TRAIL, NFFT * ZEROPAD, HOP, SR, 2.0)
    t_ref, f_ref = tj.trace_peak(*args, adaptation_mode=mode)
    t_got, f_got = tt.trace_peak(*args, adaptation_mode=mode, device="cpu")
    assert np.array_equal(t_got, t_ref)
    np.testing.assert_allclose(f_got, f_ref, rtol=2e-4)


def test_adaptive_collapsed_band_holds():
    """A band that collapses (NU <= NL near the top of the spectrum) holds
    the previous frequency in both packages."""
    num_bins, T = 64, 40
    spec = np.full((num_bins, T), 1e-6, np.float32)
    spec[61, :] = 1.0
    sr, fft = 8000, 126
    trail = [(0.0, 61 * sr / fft), (T * 32 / sr, 61 * sr / fft)]
    # a 0.01-semitone band rounds to NL == NU: every frame holds the seed
    ref = tj.trace_peak(spec, np.zeros((100, 1)), trail, fft, 32, sr, 0.01,
                        adaptation_mode="Linear")[1]
    got = tt.trace_peak(spec, np.zeros((100, 1)), trail, fft, 32, sr, 0.01,
                        adaptation_mode="Linear", device="cpu")[1]
    np.testing.assert_allclose(got, ref, rtol=2e-4)
    np.testing.assert_allclose(got, np.float32(trail[0][1]), rtol=1e-6)


def test_adaptive_step_core_matches_jax():
    rng = np.random.default_rng(3)
    frame = rng.random(257).astype(np.float32)
    hist = np.log2(np.array([1000.0, 1010.0, 1005.0, 1020.0], np.float32))
    for mode in ("Constant", "Linear", "Average"):
        h_ref, f_ref = tj.adaptive_step_core(jnp.asarray(frame),
                                             tuple(jnp.asarray(v) for v in hist),
                                             np.float32(3.0), mode, 512, 8000)
        h_got, f_got = tt.adaptive_step_core(torch.from_numpy(frame),
                                             tuple(torch.tensor(v) for v in hist),
                                             np.float32(3.0), mode, 512, 8000)
        np.testing.assert_allclose(float(f_got), float(f_ref), rtol=1e-6)
        np.testing.assert_allclose([float(v) for v in h_got],
                                   [float(v) for v in h_ref], rtol=1e-6)


def test_trace_partials_matches_jax(take):
    sig, spec = take
    # a trail spanning a band (a flat trail gives JAX an empty band)
    args = (spec, sig, [(0.0, 1400.0), (3.0, 1650.0)], NFFT * ZEROPAD, HOP, SR, 1.0)
    t_ref, p_ref, m_ref = tj.trace_partials(*args)
    t_got, p_got, m_got = tt.trace_partials(*args, device="cpu")
    assert np.array_equal(t_got, t_ref)
    np.testing.assert_allclose(p_got, p_ref, rtol=2e-4)
    np.testing.assert_allclose(m_got, m_ref, rtol=2e-4)


def test_interp_rows_matches_jnp_interp():
    rng = np.random.default_rng(8)
    xp = np.sort(rng.uniform(0, 10, 33)).astype(np.float32)
    fp = rng.standard_normal((4, 33)).astype(np.float32)
    x = np.concatenate([[-1.0, xp[0], xp[-1], 11.0], rng.uniform(0, 10, 50)]).astype(np.float32)
    got = tt.interp_rows(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    for r in range(4):
        np.testing.assert_allclose(got[r].numpy(),
                                   np.asarray(jnp.interp(x, xp, fp[r])), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("rpm", [None, 33.0])
def test_fit_sin_and_sine_reg_equal(rpm):
    t = np.linspace(0, 4, 400)
    y = 0.02 * np.sin(2 * np.pi * 0.55 * t + 0.3) + 0.001 + 1e-4 * np.sin(40 * t)
    a, b = tt.fit_sin(t, y, assumed_freq=rpm and rpm / 60), tj.fit_sin(
        t, y, assumed_freq=rpm and rpm / 60)
    for key in ("amp", "omega", "phase", "offset", "freq", "period", "maxcov"):
        assert a[key] == b[key], key
    curve = np.stack([t, y], -1)
    assert tt.trace_sine_reg(curve, 0.5, 3.5, rpm) == tj.trace_sine_reg(curve, 0.5, 3.5, rpm)


def test_adapt_band_and_helpers_equal():
    freqs = [1000.0, 1010.0, 1030.0, 1020.0, 990.0]
    for mode in ("None", "Constant", "Linear", "Average"):
        for i in range(len(freqs)):
            a = tt.adapt_band(freqs, 513, 1024 / 8000, 1.0, mode, i)
            b = tj.adapt_band(freqs, 513, 1024 / 8000, 1.0, mode, i)
            assert a[:2] == b[:2] and a[3] == b[3] and np.array_equal(a[2], b[2])
    y = np.array([1.0, np.nan, np.nan, 4.0, np.nan])
    assert np.array_equal(tt.interp_nans(y.copy()), tj.interp_nans(y.copy()))
    z = np.array([0.1, -0.2, 0.3, 0.4, -0.1])
    assert np.array_equal(tt.zero_crossings(z), tj.zero_crossings(z))
