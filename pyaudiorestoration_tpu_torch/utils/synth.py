"""The synthesized wow/flutter take and the flutter measure that the port's
bench, ``chip_smoke.py`` and ``profile_stages.py`` share: one recipe, so
their inputs and checks are the same."""

from __future__ import annotations

import numpy as np

F0 = 3150.0  # the wow/flutter test tone of IEC 60386


def tone_stability(sig, sr, smooth_periods=32):
    """Relative std of a tone's instantaneous frequency from sub-sample zero
    crossings averaged over ``smooth_periods`` periods (tests/test_respeeder.py)."""
    idx = np.where(np.bitwise_xor(sig[1:] > 0, sig[:-1] > 0))[0]
    crossings = idx + sig[idx] / (sig[idx] - sig[idx + 1])
    k = smooth_periods
    freqs = 2 * sr / ((crossings[2 * k:] - crossings[:-2 * k]) / k)
    core = freqs[len(freqs) // 10: -len(freqs) // 10]
    return float(np.std(core) / np.mean(core))


def wow_take(sr, seconds, seed=0):
    """Stereo pilot tone with 0.55 Hz wow (0.8 %) and 6.3 Hz flutter (0.15 %):
    drift bound ~10 samples at max_n ~563, inside the 16 bucket."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    speed = (1.0 + 0.008 * np.sin(2 * np.pi * 0.55 * t)
             + 0.0015 * np.sin(2 * np.pi * 6.3 * t + 1.0))
    phase = 2 * np.pi * F0 * np.cumsum(speed) / sr
    rng = np.random.default_rng(seed)
    mono = (0.5 * np.sin(phase) + 1e-3 * rng.standard_normal(n)).astype(np.float32)
    return np.stack([mono, mono * 0.8], -1)
