"""Restoration quality metrics (counterpart of
pyaudiorestoration_tpu/utils/metrics.py).

The reference has no measurement tooling (verification is visual,
SURVEY.md §4); BASELINE.md's quality criterion is "output SNR / spectral
distance vs reference output on the same inputs".  These are the
first-class versions of the helpers the test-suite and baseline runner
grew: flutter (pilot-tone speed instability), residual SNR, and log-mel
spectral distance.

``flutter`` and ``snr_db`` are host float64 numpy, copies of the JAX
package's, so their answers are the same to the bit.  ``spectral_distance_db``
takes its magnitudes and the mel product on ``device`` and downloads one
scalar.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fourier, units
from .device import resolve_device

__all__ = ["flutter", "snr_db", "spectral_distance_db", "measure_files"]


def flutter(signal, sr, smooth_periods: int = 32):
    """Relative short-term frequency instability of a (near-)pilot tone.

    Sub-sample zero-crossing intervals -> per-period frequency track ->
    std/mean over the interior.  ~0 for a clean tone; wow/flutter shows up
    directly (e.g. the flutter.flac fixture measures ~0.0055 before and
    ~0.0011 after restoration).
    """
    x = np.asarray(signal, dtype=np.float64)
    if x.ndim == 2:
        x = x[:, 0]
    idx = np.where(np.bitwise_xor(x[1:] > 0, x[:-1] > 0))[0]
    if len(idx) < 4 * smooth_periods:
        raise ValueError("not enough zero crossings for a flutter estimate")
    frac = x[idx] / (x[idx] - x[idx + 1])
    crossings = idx + frac
    k = smooth_periods
    # crossings are half-periods, so a 2k-crossing span is k full periods
    avg_period = (crossings[2 * k:] - crossings[:-2 * k]) / k
    freq = sr / avg_period
    trim = max(1, len(freq) // 10)  # // 10 can be 0, and freq[0:-0] is empty
    if len(freq) <= 2 * trim:
        raise ValueError("not enough zero crossings for a flutter estimate")
    core = freq[trim:-trim]
    return float(np.std(core) / np.mean(core))


def snr_db(reference, test):
    """Residual SNR of ``test`` against ``reference`` (aligned, same length)."""
    a = np.asarray(reference, np.float64)
    b = np.asarray(test, np.float64)
    n = min(len(a), len(b))
    a, b = a[:n], b[:n]
    noise = np.mean((a - b) ** 2)
    if noise == 0:
        return float("inf")
    return float(10 * np.log10(np.mean(a ** 2) / noise))


def _mel_filterbank(sr, n_fft: int, n_mels: int, fmin: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) float32 triangular filters on a mel grid
    from ``fmin`` to Nyquist, built on the host as the JAX package builds
    them."""
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    mel_pts = np.linspace(float(units.to_mel(fmin)), float(units.to_mel(sr / 2)),
                          n_mels + 2)
    hz_pts = np.asarray(units.to_Hz(mel_pts))
    fb = np.zeros((n_mels, len(freqs)), np.float32)
    for m in range(n_mels):
        lo, c, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (freqs - lo) / max(c - lo, 1e-9)
        down = (hi - freqs) / max(hi - c, 1e-9)
        fb[m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


def spectral_distance_db(a, b, sr, n_fft: int = 2048, hop: int = 512,
                         n_mels: int = 64, fmin: float = 30.0, device="cuda"):
    """Mean |dB| difference between log-mel spectrograms (alignment-tolerant
    timbre distance).  ``a``/``b``: host (n,) or (n, C) arrays (channel 0)."""
    dev = resolve_device(device)  # also keeps the mel product out of TF32
    fb = torch.as_tensor(_mel_filterbank(sr, n_fft, n_mels, fmin), device=dev)

    def mel_spec(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 2:
            x = x[:, 0]
        mag = fourier.get_mag(np.ascontiguousarray(x), n_fft, hop, "hann", device=dev)
        return 10 * torch.log10(fb @ (mag ** 2) + 1e-10)

    sa, sb = mel_spec(a), mel_spec(b)
    t = min(sa.shape[1], sb.shape[1])
    return float(torch.mean(torch.abs(sa[:, :t] - sb[:, :t])))


def measure_files(path_a, path_b=None, metric: str = "all", device="cuda"):
    """CLI backend: measure one file (flutter) or compare two (snr/spectral).

    Returns a dict of metric name -> value.
    """
    from . import audio_io

    resolve_device(device)
    if metric in ("snr", "spectral") and path_b is None:
        raise ValueError(f"metric '{metric}' needs a second file to compare to")
    a, sr, _ = audio_io.read_file(path_a)
    out = {}
    if metric in ("all", "flutter"):
        try:
            out["flutter"] = round(flutter(a, sr), 6)
        except ValueError:
            out["flutter"] = None
    if path_b is not None:
        b, sr_b, _ = audio_io.read_file(path_b)
        if sr_b != sr:
            raise ValueError("sample rates differ")
        if metric in ("all", "snr"):
            s = snr_db(a[:, 0], b[:, 0])
            # keep the CLI's JSON strict (json.dumps would emit the
            # non-standard `Infinity` token for identical files)
            out["snr_db"] = None if np.isinf(s) else round(s, 2)
        if metric in ("all", "spectral"):
            out["spectral_distance_db"] = round(
                spectral_distance_db(a, b, sr, device=device), 3)
    return out
