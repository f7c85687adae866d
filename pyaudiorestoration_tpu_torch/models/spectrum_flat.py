"""Averaged spectra of audio files (counterpart of
pyaudiorestoration_tpu/models/spectrum_flat.py; reference:
util/spectrum_flat.py).

Every selected channel goes through one batched STFT on the device; the dB
and the temporal mean stay there, and only the (channels, bins) means (or,
with ``temporal_mean=False``, the spectra) are downloaded.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops import fourier, units
from ..utils import audio_io, streaming
from ..utils.device import resolve_device

__all__ = ["channel_map", "spectra_from_audio", "spectrum_from_audio",
           "spectrum_from_audio_stereo"]

channel_map = {"L": (0,), "R": (1,), "L+R": (0, 1), "Mean": (0, 1)}


def _channels(channel_mode, num_channels):
    """The channels of ``channel_mode`` that exist, stopping at the first
    missing one with the reference's warning (the mono fallback)."""
    chans = []
    for channel in channel_map[channel_mode]:
        if channel == num_channels:
            logging.warning("not enough channels for L/R comparison - fallback to mono")
            break
        chans.append(channel)
    return chans


def db_spectra(signal, chans, fft_size, hop, device="cuda"):
    """(len(chans), bins, frames) float32 dB magnitude tensor of the columns
    ``chans`` of the (n, C) host ``signal``, hann window, on ``device``."""
    x = torch.as_tensor(np.ascontiguousarray(signal[:, chans].T),
                        device=resolve_device(device))
    return units.to_dB(fourier.get_mag(x, fft_size, hop, "hann"))


def spectra_from_audio(filename, fft_size=4096, hop=256, channel_mode="L",
                       temporal_mean=True, stream="auto",
                       stream_threshold_bytes: int = 1 << 30, device="cuda"):
    """Per-channel averaged dB spectra (spectrum_flat.py:10-28), a list of
    host arrays, and the sample rate.

    Temporal means of big files accumulate blockwise (frame-exact global
    grid, float64 partial sums), so difeq-style analyses never decode the
    whole recording (``stream`` True/False/"auto")."""
    resolve_device(device)
    if temporal_mean and streaming.should_stream(filename, stream,
                                                 stream_threshold_bytes):
        return _spectra_from_audio_streamed(filename, fft_size, hop, channel_mode,
                                            device=device)
    signal, sr, num_channels = audio_io.read_file(filename)
    chans = _channels(channel_mode, num_channels)
    spectra = []
    if chans:
        db = db_spectra(signal, chans, fft_size, hop, device)
        if temporal_mean:
            db = db.mean(dim=-1)
        spectra = list(db.cpu().numpy())
    if channel_mode == "Mean":
        spectra = [np.mean(spectra, axis=0)]
    return spectra, sr


def _spectra_from_audio_streamed(filename, fft_size, hop, channel_mode,
                                 block_frames: int = 4096, device="cuda"):
    """Blockwise temporal-mean dB spectra on the exact global frame grid."""
    dev = resolve_device(device)
    pad = fft_size // 2
    with audio_io.StreamReader(filename) as r:
        sr = r.sample_rate
        n = int(r.frames)
        chans = _channels(channel_mode, r.channels)
        T = (n + 2 * pad - fft_size) // hop + 1
        acc = torch.zeros((len(chans), fft_size // 2 + 1), dtype=torch.float64, device=dev)
        for t0 in range(0, T if chans else 0, block_frames):
            t1 = min(T, t0 + block_frames)
            a = t0 * hop - pad
            b = (t1 - 1) * hop - pad + fft_size
            span = torch.as_tensor(streaming.virtual_read(r, a, b, 0, chans).T, device=dev)
            db = units.to_dB(fourier.get_mag(span, fft_size, hop, "hann", center=False))
            acc += db.to(torch.float64).sum(dim=-1)
        spectra = list((acc / T).cpu().numpy())
    if channel_mode == "Mean":
        spectra = [np.mean(spectra, axis=0)]
    return spectra, sr


def spectrum_from_audio(filename, fft_size=4096, hop=256, channel_mode="L",
                        temporal_mean=True, device="cuda"):
    spectra, sr = spectra_from_audio(filename, fft_size, hop, channel_mode, temporal_mean,
                                     device=device)
    if len(spectra) > 1:
        return np.mean(spectra, axis=0), sr
    return spectra[0], sr


def spectrum_from_audio_stereo(filename, fft_size=4096, hop=256, channel_mode="L",
                               temporal_mean=True, device="cuda"):
    spectra, sr = spectra_from_audio(filename, fft_size, hop, channel_mode, temporal_mean,
                                     device=device)
    if len(spectra) < 2:
        spectra.append(spectra[0])
    return spectra, sr
