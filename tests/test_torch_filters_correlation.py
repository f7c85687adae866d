"""The port's correlation and IIR filters against the JAX package and scipy
on the CPU.  The device sosfiltfilt is a float64 doubling scan held to the
JAX package's own gate (tests/test_correlation_filters.py:89-115): above
100 dB against scipy's float64 sosfiltfilt."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as dsp

from pyaudiorestoration_tpu.ops import correlation as cj
from pyaudiorestoration_tpu.ops import filters as fj
from pyaudiorestoration_tpu_torch.ops import correlation as ct
from pyaudiorestoration_tpu_torch.ops import filters as ftl

torch.set_num_threads(2)


def _snr(ref, got):
    e = np.asarray(got, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum(e ** 2), 1e-300))


@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("la,lb", [(300, 300), (300, 120), (77, 200)])
def test_xcorr_matches_jax(mode, la, lb):
    rng = np.random.default_rng(la * lb)
    a = rng.standard_normal((3, la)).astype(np.float32)
    b = rng.standard_normal((3, lb)).astype(np.float32)
    ref = np.asarray(cj.xcorr(jnp.asarray(a), jnp.asarray(b), mode=mode))
    got = ct.xcorr(torch.from_numpy(a), torch.from_numpy(b), mode=mode).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_xcorr_unknown_mode_raises():
    with pytest.raises(ValueError):
        ct.xcorr(torch.ones(8), torch.ones(8), mode="circular")


def test_parabolic_matches_jax():
    rng = np.random.default_rng(3)
    f = rng.standard_normal(64).astype(np.float32)
    for x in (1, 17, 40, 62):
        ref = cj.parabolic(jnp.asarray(f), x)
        got = ct.parabolic(torch.from_numpy(f), x)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
    flat = np.zeros(8, np.float32)  # zero curvature takes the 1e-12 guard
    np.testing.assert_allclose(float(ct.parabolic(torch.from_numpy(flat), 3)[0]),
                               float(cj.parabolic(jnp.asarray(flat), 3)[0]))


@pytest.mark.parametrize("lo,hi,fs,order", [(100, 1000, 8000, 3), (0, 500, 8000, 5),
                                            (300, 1e9, 8000, 3), (0, 1e9, 8000, 3)])
def test_host_butter_bandpass_bit_equal(lo, hi, fs, order):
    x = np.random.default_rng(1).standard_normal(4000)
    ref = fj.butter_bandpass_filter(x, lo, hi, fs, order=order, backend="host")
    got = ftl.butter_bandpass_filter(x, lo, hi, fs, order=order, backend="host")
    assert np.array_equal(np.asarray(got), np.asarray(ref))


def test_sosfiltfilt_float64_scan_above_100db():
    """The dropout band cascade's edges plus a sub-bass band whose poles sit
    ~1e-3 from the unit circle (the JAX test's cases)."""
    sr = 44100
    x = (0.3 * np.random.default_rng(1234).standard_normal(1 << 16)).astype(np.float32)
    worst_f32 = np.inf
    for lo, hi in [(100, 147), (681, 1000), (40, 80)]:
        sos = dsp.butter(3, [lo / (sr / 2), hi / (sr / 2)], btype="band", output="sos")
        ref = dsp.sosfiltfilt(sos, x.astype(np.float64))
        got = ftl.sosfiltfilt(sos, torch.from_numpy(x))
        assert got.dtype == torch.float32
        assert _snr(ref, got.numpy()) > 100.0, (lo, hi)
        worst_f32 = min(worst_f32, _snr(ref, ftl.sosfiltfilt(
            sos, x, compensated=False, device="cpu").numpy()))
    assert worst_f32 < 100.0  # compensated=False, the float32 scan, misses the gate


def test_sosfiltfilt_batch_and_device_butter():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5000)).astype(np.float32)
    sos = fj._design_butter(300.0, 900.0, 8000.0, 3)
    ref = dsp.sosfiltfilt(sos, x.astype(np.float64), axis=-1)
    got = ftl.butter_bandpass_filter(x, 300, 900, 8000, order=3, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == x.shape
    for r, g in zip(ref, got.numpy()):
        assert _snr(r, g) > 100.0


@pytest.mark.parametrize("with_zi", [False, True])
def test_sosfilt_matches_scipy(with_zi):
    sos = dsp.butter(3, 0.2, output="sos")
    x = np.random.default_rng(2).standard_normal(2000).astype(np.float32)
    zi = 0.7 * dsp.sosfilt_zi(sos) if with_zi else None
    ref = dsp.sosfilt(sos, x, zi=zi)[0] if with_zi else dsp.sosfilt(sos, x)
    got = ftl.sosfilt(sos, x, zi=zi, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_moving_average_and_make_odd():
    a = np.random.default_rng(4).standard_normal(50).astype(np.float32)
    for n in (1, 3, 7):
        np.testing.assert_array_equal(ftl.moving_average(a, n), fj.moving_average(a, n))
        np.testing.assert_allclose(ftl.moving_average(torch.from_numpy(a), n).numpy(),
                                   np.asarray(fj.moving_average(jnp.asarray(a), n)),
                                   atol=1e-6)
    assert [ftl.make_odd(v) for v in (2, 3, 10)] == [fj.make_odd(v) for v in (2, 3, 10)]
