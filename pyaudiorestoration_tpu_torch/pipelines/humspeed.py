"""Hum-based speed matching (counterpart of
pyaudiorestoration_tpu/pipelines/humspeed.py; reference tool:
humspeed_gui.py).

A long FFT (2**19) of the recording reveals the mains hum; the deviation of
the measured hum peak from 50/60 Hz (or a harmonic) gives the global speed
error, corrected with a constant-ratio resample
(humspeed_gui.py:138-183, 185-198).  In memory the resample is
``resample_ratio`` (kernel K1's grid entry on the card, one launch a
channel); streamed, the constant ratio is a constant speed curve through
``restore_file_streamed`` (K1's plan entry, one launch a tile).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..models.spectrum_flat import spectrum_from_audio
from ..ops import correlation, fourier, resampling
from ..utils import audio_io, streaming
from ..utils.device import resolve_device
from ..utils.timing import Stages

__all__ = ["get_spectrum", "track_to", "analyze_hum", "resample_file"]


def get_spectrum(file_src, channel_mode="L+R", fft_size=2 ** 19, device="cuda"):
    """Averaged dB spectrum with hop = 2*fft_size (humspeed_gui.py:18-24)."""
    hop = fft_size * 2
    spectrum, sr = spectrum_from_audio(file_src, fft_size, hop, channel_mode,
                                       device=device)
    return fourier.fft_freqs(fft_size, sr), spectrum, sr


def track_to(freqs, spectrum, sr, fft_size, xpos, hum_freqs, tolerance=8):
    """Find the spectral peak near ``xpos`` and match it to the closest hum
    harmonic (humspeed_gui.py:138-183).  The parabolic refinement runs in
    float32, as JAX's.  Returns (measured_freq, dB, ratio, percent) or None
    if no match."""
    l_ratio = 1 - tolerance / 100
    r_ratio = 1 + tolerance / 100
    border_l = max(np.argmin(np.abs(freqs - xpos * l_ratio)), 0)
    border_r = min(np.argmin(np.abs(freqs - xpos * r_ratio)), len(freqs))
    raw_index = np.argmax(spectrum[border_l:border_r]) + border_l
    interp_index, dB = correlation.parabolic(
        torch.as_tensor(np.asarray(spectrum, np.float32)), int(raw_index))
    freq = float(interp_index) * sr / fft_size
    closest_hum = hum_freqs[np.argmin(np.abs(np.asarray(hum_freqs) - freq))]
    ratio = closest_hum / freq
    percent = (ratio - 1) * 100
    if abs(percent) > tolerance:
        logging.info("hum was not close enough")
        return None
    return freq, float(dB), float(ratio), float(percent)


def analyze_hum(file_src, base_hum=50, num_harmonies=2, tolerance=8,
                channel_mode="L+R", fft_size=2 ** 19, device="cuda"):
    """Measure the speed error from every hum harmonic
    (humspeed_gui.py:102-112).  Returns a list of match dicts."""
    freqs, spectrum, sr = get_spectrum(file_src, channel_mode, fft_size, device=device)
    hum_freqs = np.arange(base_hum, base_hum + base_hum * num_harmonies + 1, base_hum)
    matches = []
    for hum in hum_freqs:
        res = track_to(freqs, spectrum, sr, fft_size, hum, hum_freqs, tolerance)
        if res:
            freq, dB, ratio, percent = res
            matches.append({"target": float(hum), "freq": freq, "dB": dB,
                            "ratio": ratio, "percent": percent})
    return matches


def resample_file(file_src, ratio=None, stream="auto",
                  stream_threshold_bytes: int = 1 << 30, device="cuda", timings=None,
                  **analyze_kwargs):
    """Resample globally by the measured (or given) hum ratio
    (humspeed_gui.py:185-198).  Returns the output path.

    ``stream``: the larger-than-memory path: the constant ratio becomes a
    constant frame-rate speed curve through the streamed two-pass restore
    (the hum analysis itself reads only one 2**19 window).  ``timings``, a
    dict, receives the in-memory path's seconds: the hum analysis, read,
    ``resample_ratio``'s stages, write."""
    dev = resolve_device(device)
    stages = Stages(timings, dev)
    if ratio is None:
        matches = analyze_hum(file_src, device=dev, **analyze_kwargs)
        if not matches:
            raise ValueError("no hum match found")
        ratio = matches[-1]["ratio"]
    percentage = (ratio - 1) * 100
    if streaming.should_stream(file_src, stream, stream_threshold_bytes):
        from . import respeeder_device as rdev

        fft_size, fft_overlap = 4096, 8
        hop = fft_size // fft_overlap
        with audio_io.StreamReader(file_src) as r:
            n = int(r.frames)
        n_frames = (n + 2 * (fft_size // 2) - fft_size) // hop + 1
        curve = np.full(n_frames, 1.0 / float(ratio), np.float64)
        return rdev.restore_file_streamed(
            file_src, fft_size=fft_size, fft_overlap=fft_overlap,
            suffix="ampled_%.3f" % percentage, speed_curve=curve, device=dev)
    stages.mark("analyze")
    signal, sr, num_channels = audio_io.read_file(file_src)
    stages.mark("read")
    res = resampling.resample_ratio(signal, sr * ratio, sr, axis=0, device=dev,
                                    timings=timings)
    stages = Stages(timings, dev)
    path = audio_io.write_file(file_src, res, sr, num_channels,
                               "_resampled_%.3f" % percentage)
    stages.mark("write")
    return path
