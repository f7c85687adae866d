"""Tracking stages of the port against the JAX package on the CPU: masked
peak refinement, reflect centring, banded-DFT and full-rFFT peak tracking,
the exact-limb centring and the speed curve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.models import trackers as tj
from pyaudiorestoration_tpu.ops import correlation as cj
from pyaudiorestoration_tpu.pipelines import respeeder_device as rj
from pyaudiorestoration_tpu_torch.models import trackers as tt
from pyaudiorestoration_tpu_torch.ops import correlation as ct
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

torch.set_num_threads(2)

# refined bins: the matmul / FFT sums run in another order than XLA's, so a
# bin may land one float32 ulp away (6.1e-5 at bins 512-1023): 2 ulps
REFINED_RTOL = 2.4e-7


def _magnitudes(case, T=300, F=64, seed=0):
    rng = np.random.default_rng(seed)
    if case == "random":
        mag = rng.random((T, F))
    elif case == "ties":  # few levels: many equal maxima, first one wins
        mag = rng.integers(0, 4, (T, F)).astype(np.float64)
    elif case == "flat":
        mag = np.ones((T, F))
    else:  # "edge": the maximum sits on a band or spectrum edge
        mag = rng.random((T, F)) * 0.5
        mag[: T // 3, 0] = 2.0
        mag[T // 3: 2 * T // 3, F - 1] = 2.0
        mag[2 * T // 3:, 20] = 2.0
    nl = rng.integers(0, F // 2, T)
    nu = nl + rng.integers(1, F // 2, T)
    if case == "edge":
        nl[: T // 3] = 0
        nu[T // 3: 2 * T // 3] = F
        nl[2 * T // 3:], nu[2 * T // 3:] = 20, 21  # one-bin band
    return mag.astype(np.float32), nl.astype(np.int32), nu.astype(np.int32)


@pytest.mark.parametrize("case", ["random", "ties", "flat", "edge"])
@pytest.mark.parametrize("offset", [0.0, 37.0])
def test_masked_peak_refine_matches_jax(case, offset):
    mag, nl, nu = _magnitudes(case)
    ref = np.asarray(tj.masked_peak_refine(jnp.asarray(mag), jnp.asarray(nl),
                                           jnp.asarray(nu), bin_offset=offset))
    got = tt.masked_peak_refine(torch.from_numpy(mag), torch.from_numpy(nl),
                                torch.from_numpy(nu), bin_offset=offset).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_parabolic_batch_matches_jax():
    rng = np.random.default_rng(1)
    f = rng.random((50, 40)).astype(np.float32)
    f[:5, 10:13] = 0.25  # zero denominator
    x = rng.integers(1, 39, 50)
    x[:5] = 11
    ref = cj.parabolic_batch(jnp.asarray(f), jnp.asarray(x.astype(np.int32)))
    got = ct.parabolic_batch(torch.from_numpy(f), torch.from_numpy(x))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 17, 40])
def test_reflect_pad_matches_jnp_pad(n):
    x = np.arange(1, n + 1, dtype=np.float32)
    got = rt._reflect_pad(torch.from_numpy(x), 16).numpy()
    assert np.array_equal(got, np.asarray(jnp.pad(jnp.asarray(x), 16, mode="reflect")))


def _log_speeds(T, seed):
    rng = np.random.default_rng(seed)
    return (9.1 + 0.03 * rng.standard_normal(T)).astype(np.float32)


@pytest.mark.parametrize("T", [216, 20000])
@pytest.mark.parametrize("masked", [False, True])
def test_quantized_log_sums_limbs_exact(T, masked):
    ls = _log_speeds(T, T)
    mask = (np.arange(T) < T - 37).astype(np.float32) if masked else None
    ref = rj.quantized_log_sums(jnp.asarray(ls), 9.1,
                                mask=None if mask is None else jnp.asarray(mask))
    got = rt.quantized_log_sums(torch.from_numpy(ls), 9.1,
                                mask=None if mask is None else torch.from_numpy(mask))
    for r, g in zip(ref, got):
        assert float(g) == float(r)
    count = T - 37 if masked else T
    inv = rj.inv_count_limbs(count) if masked else None
    m_ref = rj.exact_log_center(ref, T, 9.1,
                                inv_limbs=None if inv is None else jnp.asarray(inv))
    m_got = rt.exact_log_center(got, T, 9.1,
                                inv_limbs=None if inv is None else torch.from_numpy(inv))
    assert float(m_got) == float(m_ref)


@pytest.mark.parametrize("center,masked", [(None, False), (9.07, False), (9.07, True)])
def test_normalize_speeds_matches_jax(center, masked):
    """The exact-limb centring gives the reference's mean bit for bit, so
    speeds agree within 1e-6 relative (an ulp of pow and of log).  The plain
    float mean (center=None) is summed in another order than XLA's and may
    land an ulp of log2(bin) away (~9.5e-7, a 6.6e-7 relative speed step):
    2e-6 relative."""
    rng = np.random.default_rng(7)
    T = 500
    refined = (550.0 + 12.0 * rng.standard_normal(T)).astype(np.float32)
    fm = inv = None
    if masked:
        fm = (np.arange(T) < 420).astype(np.float32)
        inv = rj.inv_count_limbs(420)
    ref = np.asarray(rj.normalize_speeds(
        jnp.asarray(refined), center=center,
        frame_mask=None if fm is None else jnp.asarray(fm),
        inv_limbs=None if inv is None else jnp.asarray(inv)))
    got = rt.normalize_speeds(
        torch.from_numpy(refined), center=center,
        frame_mask=None if fm is None else torch.from_numpy(fm),
        inv_limbs=None if inv is None else torch.from_numpy(inv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6 if center else 2e-6, atol=0)


def _tone(sr, seconds, f0=1000.0, depth=0.015, hz=1.7):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    speed = 1.0 + depth * np.sin(2 * np.pi * hz * t)
    return np.sin(2 * np.pi * f0 * np.cumsum(speed) / sr).astype(np.float32)


def _limits(x, fft_size, hop, zp, sr, f0=1000.0):
    f0_bin = int(round(f0 * fft_size * zp / sr))
    n_frames = (len(x) + (fft_size // 2) * 2 - fft_size) // hop + 1
    return f0_bin - 12, f0_bin + 13, n_frames


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("chunk_frames", [4096, 100])
def test_track_peaks_span_matches_jax(banded, chunk_frames):
    sr, fft_size, hop, zp = 16000, 2048, 256, 2
    x = _tone(sr, 2.0)
    NLv, NUv, n_frames = _limits(x, fft_size, hop, zp, sr)
    band = (NLv - 1, NUv + 1) if banded else None
    xp = np.asarray(jnp.pad(jnp.asarray(x), fft_size // 2, mode="reflect"))
    ref = np.asarray(rj.track_peaks_span(
        jnp.asarray(xp), jnp.full((n_frames,), NLv, jnp.int32),
        jnp.full((n_frames,), NUv, jnp.int32), n_frames, fft_size, hop, zp,
        chunk_frames=chunk_frames, band=band))
    got = rt.track_peaks_span(
        torch.from_numpy(xp.copy()), torch.full((n_frames,), NLv, dtype=torch.int32),
        torch.full((n_frames,), NUv, dtype=torch.int32), n_frames, fft_size, hop,
        zp, chunk_frames=chunk_frames, band=band).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=REFINED_RTOL, atol=0)


@pytest.mark.parametrize("banded", [True, False])
def test_track_speed_device_matches_jax(banded):
    """Speeds on the main path (banded) agree within 1e-6 relative; the
    full-rFFT branch centres on a plain float mean whose reduction XLA
    orders differently (an ulp of log2(bin) apart), so it is held to the
    2e-5 bound of test_restore_fused.py:99-121."""
    sr, fft_size, hop, zp = 16000, 2048, 256, 2
    x = _tone(sr, 3.0)
    NLv, NUv, n_frames = _limits(x, fft_size, hop, zp, sr)
    band = (NLv - 1, NUv + 1) if banded else None
    ref = np.asarray(rj.track_speed_device(
        jnp.asarray(x), jnp.full((n_frames,), NLv, jnp.int32),
        jnp.full((n_frames,), NUv, jnp.int32), fft_size, hop, zp, band=band))
    got = rt.track_speed_device(
        torch.from_numpy(x), torch.full((n_frames,), NLv, dtype=torch.int32),
        torch.full((n_frames,), NUv, dtype=torch.int32), fft_size, hop, zp,
        band=band).numpy()
    if banded:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("n", [300, 1500])
def test_track_speed_device_short_input(n):
    """Takes shorter than n_fft/2 reflect more than once (F.pad's reflect
    mode refuses them); the port follows jnp.pad."""
    sr, fft_size, hop, zp = 8000, 1024, 128, 2
    x = _tone(sr, n / sr, f0=500.0)
    NLv, NUv, n_frames = _limits(x, fft_size, hop, zp, sr, f0=500.0)
    band = (NLv - 1, NUv + 1)
    ref = np.asarray(rj.track_speed_device(
        jnp.asarray(x), jnp.full((n_frames,), NLv, jnp.int32),
        jnp.full((n_frames,), NUv, jnp.int32), fft_size, hop, zp, band=band))
    got = rt.track_speed_device(
        torch.from_numpy(x), torch.full((n_frames,), NLv, dtype=torch.int32),
        torch.full((n_frames,), NUv, dtype=torch.int32), fft_size, hop, zp,
        band=band).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
