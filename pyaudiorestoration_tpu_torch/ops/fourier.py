"""STFT engine of the port, forward side (counterpart of
pyaudiorestoration_tpu/ops/fourier.py:38-111).

The reference's spectral conventions: ``blackmanharris`` window, reflect
centring that repeats the reflection for pads longer than the signal (as
``jnp.pad(mode="reflect")``; ``F.pad`` refuses those), hop ``step``, a
zero-padding factor that lengthens the FFT only, a global ``1/sqrt(n_fft)``
scale and the (n_freqs, n_frames) layout.  ``torch.stft`` is not used: its
centring, window and scale conventions differ.  The inverse side (``istft``,
``window_sumsquare``, ...) is not ported yet.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy import signal as _dsp

from ..utils.device import as_device_tensor

__all__ = ["get_window", "to_mag", "fft_freqs", "n_frames_for", "frame_signal",
           "reflect_pad", "stft", "get_mag"]


@functools.lru_cache(maxsize=64)
def get_window(window_name: str, n: int, fftbins: bool = True) -> np.ndarray:
    """Host-side window design (static, cached)."""
    return _dsp.get_window(window_name, n, fftbins=fftbins).astype(np.float32)


def to_mag(spectrum):
    """Magnitude with the reference's epsilon floor (fourier.py:23-24)."""
    return torch.abs(spectrum) + 1e-7


def fft_freqs(n_fft: int, fs: float) -> np.ndarray:
    """Frequencies of the rFFT bins (fourier.py:690-700).  Host numpy."""
    return np.arange(0, (n_fft // 2 + 1)) / float(n_fft) * float(fs)


def n_frames_for(n_samples: int, n_fft: int, step: int, center: bool = True) -> int:
    """Number of STFT frames produced for a signal of ``n_samples``."""
    padded = n_samples + (n_fft // 2) * 2 if center else n_samples
    return max(0, (padded - n_fft) // step + 1)


def reflect_pad(x, pad: int):
    """``jnp.pad(x, pad, mode="reflect")`` over the last axis: the edge
    sample is not repeated, and pads longer than the signal reflect again
    (period 2(n-1)), where ``F.pad(mode="reflect")`` refuses."""
    n = x.shape[-1]
    i = torch.arange(-pad, n + pad, device=x.device)
    if n == 1:
        return x[..., torch.zeros_like(i)]
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return x[..., torch.where(i >= n, period - i, i)]


def frame_signal(x, n_fft: int, step: int, center: bool = True):
    """Overlapping frames of the last axis, shape (..., n_frames, n_fft);
    frame t starts at sample t*step of the (centred) signal."""
    if center:
        x = reflect_pad(x, n_fft // 2)
    return x.unfold(-1, n_fft, step)


def stft(x, n_fft: int = 1024, step: int | None = 512,
         window_name: str = "blackmanharris", zeropad: int = 1,
         center: bool = True, device="cuda"):
    """Short-time Fourier transform (fourier.py:37-75).

    ``x`` is (n,) or (channels, n), a tensor (which keeps its device) or a
    host array (uploaded to ``device``).  Returns complex64
    (n_freqs, n_frames) or (channels, n_freqs, n_frames)."""
    n_fft = int(n_fft)
    step = max(n_fft // 2, 1) if step is None else int(step)
    x = as_device_tensor(x, device, torch.float32)
    if x.dim() not in (1, 2):
        raise ValueError("x must be 1D or 2D (channels, time)")
    window = torch.as_tensor(get_window(window_name, n_fft), device=x.device)
    frames = frame_signal(x, n_fft, step, center) * window
    spec = torch.fft.rfft(frames, n=n_fft * int(zeropad), dim=-1)
    return spec.transpose(-1, -2) / math.sqrt(n_fft)


def get_mag(*args, **kwargs):
    """Magnitude spectrogram (fourier.py:27-29)."""
    return to_mag(stft(*args, **kwargs))
