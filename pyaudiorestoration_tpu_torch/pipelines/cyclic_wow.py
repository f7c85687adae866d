"""Rotation-period-averaged wow detection for records (counterpart of
pyaudiorestoration_tpu/pipelines/cyclic_wow.py; reference:
experiments/cyclic_wow.py).

A record's wow repeats every rotation; averaging the tracked log-frequency
curve over candidate cycle lengths and maximising the averaged peak-to-peak
deviation finds the true rotation period (and hence the actual RPM).  The
spectrogram and the Peak tracker run on the device; the cycle scan is host
numpy, as JAX's.
"""

from __future__ import annotations

import numpy as np

from ..models import trackers
from ..ops import fourier
from ..utils.device import resolve_device

__all__ = ["cycle_average", "find_cycle", "analyze"]


def cycle_average(logfreq, frames_per_rotation: int):
    """Mean cycle: fold the curve into rotation-length slices and average
    (cyclic_wow.py:9-28)."""
    num_views = len(logfreq) // frames_per_rotation
    if num_views < 1:
        return np.zeros(frames_per_rotation)
    folded = logfreq[: num_views * frames_per_rotation]
    return np.mean(np.split(folded, num_views), axis=0)


def find_cycle(logfreq, frames_per_rotation_init: int, tolerance: float = 0.1):
    """Scan cycle lengths +-tolerance and pick the one maximising the averaged
    wow depth (cyclic_wow.py:50-66).  Returns (best_frames, delta, results)."""
    d = max(1, int(frames_per_rotation_init * tolerance))
    results = np.empty((2 * d, 2))
    for i in range(-d, d):
        fpr = frames_per_rotation_init + i
        avg = cycle_average(logfreq, fpr)
        results[d + i] = (fpr, np.max(avg) - np.min(avg))
    best = int(np.argmax(results[:, 1]))
    return int(results[best, 0]), float(results[best, 1]), results


def analyze(signal, sr, rpm=45.0, f0=700.0, fft_size=16384, fft_hop=None,
            tolerance=0.1, tolerance_st=10.0, device="cuda"):
    """End-to-end cyclic wow analysis of a record transfer.

    Returns a dict with the measured cycle duration, actual RPM, wow depth in
    semitones, and the averaged cycle curve."""
    dev = resolve_device(device)
    fft_hop = fft_hop or fft_size // 128
    mono = signal[:, 0] if signal.ndim == 2 else signal
    mag = fourier.get_mag(np.ascontiguousarray(mono, dtype=np.float32), fft_size, fft_hop,
                          "hann", device=dev)
    duration = len(mono) / sr
    times, freqs = trackers.trace("Peak", mag, signal if signal.ndim == 2 else signal[:, None],
                                  [(0.0, f0), (duration, f0)], fft_size, fft_hop, sr,
                                  tolerance_st=tolerance_st, device=dev)
    logfreq = np.log2(freqs)
    spr = 60.0 / rpm
    fpr_init = int(spr * sr / fft_hop)
    best_fpr, delta, results = find_cycle(logfreq, fpr_init, tolerance)
    cycle_duration = best_fpr * fft_hop / sr
    return {
        "frames_per_rotation": best_fpr,
        "cycle_duration_s": cycle_duration,
        "actual_rpm": 60.0 / cycle_duration,
        "wow_depth_semitones": delta * 12,
        "cycle_curve": cycle_average(logfreq, best_fpr),
        "scan": results,
    }
