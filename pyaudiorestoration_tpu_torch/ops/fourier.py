"""STFT engine of the port, forward side (counterpart of
pyaudiorestoration_tpu/ops/fourier.py:38-111).

The reference's spectral conventions: ``blackmanharris`` window, reflect
centring that repeats the reflection for pads longer than the signal (as
``jnp.pad(mode="reflect")``; ``F.pad`` refuses those), hop ``step``, a
zero-padding factor that lengthens the FFT only, a global ``1/sqrt(n_fft)``
scale and the (n_freqs, n_frames) layout.  ``torch.stft`` and
``torch.istft`` are not used: their centring, window, scale and trimming
conventions differ.

Inverse side (fourier.py:114-278): the overlap-add is JAX's ``n_fft // g``
static shifted adds (g = gcd(n_fft, hop)) in JAX's order, with its
sequential fallback for tiny g.  No ``index_add_`` (atomics on CUDA, no
fixed order) and no ``F.fold`` (its own order): the streamed engine's
interior bit-equality with the in-memory ``istft`` rests on the same addends
being summed in the same order.  The window envelope is host float64, cast
once to float32, as in JAX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy import signal as _dsp

from ..utils.device import as_device_tensor

__all__ = ["get_window", "to_mag", "fft_freqs", "n_frames_for", "frame_signal",
           "reflect_pad", "stft", "get_mag", "pad_center", "window_sumsquare",
           "istft", "istft_frames_raw", "fix_length"]


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


def pad_center(data: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a 1D host array to ``size`` (librosa-style, fourier.py:236-277)."""
    n = len(data)
    lpad = (size - n) // 2
    if lpad < 0:
        raise ValueError(f"Target size {size} < input size {n}")
    return np.pad(data, (lpad, size - n - lpad))


@functools.lru_cache(maxsize=64)
def _wss_cached(window_name: str, n_frames: int, hop_length: int, win_length: int,
                n_fft: int):
    """Sum-squared window envelope (fourier.py:492-546): host float64
    accumulation frame by frame, cast once to float32."""
    n = n_fft + hop_length * (n_frames - 1)
    win_sq = pad_center(get_window(window_name, win_length).astype(np.float64) ** 2, n_fft)
    x = np.zeros(n, dtype=np.float64)
    for i in range(n_frames):
        s = i * hop_length
        x[s:min(n, s + n_fft)] += win_sq[:max(0, min(n_fft, n - s))]
    return x.astype(np.float32)


def window_sumsquare(window_name, n_frames, hop_length=512, win_length=None, n_fft=2048):
    if win_length is None:
        win_length = n_fft
    return _wss_cached(window_name, int(n_frames), int(hop_length), int(win_length),
                       int(n_fft))


def _overlap_add(ytmp, hop: int, out_len: int):
    """Overlap-add windowed frames ``ytmp`` (..., n_frames, n_fft) into
    (..., out_len), frame t starting at sample t*hop (fourier.py:143-180).

    Frame starts lie on the g = gcd(n_fft, hop) grid, so the sum is
    ``n_fft // g`` shifted adds over (..., g) blocks, chunk j of every frame
    in turn (j = 0 first): block b collects its frames in decreasing t, as
    JAX's padded adds do (an added zero changes no bit).  When the shift
    count would pass 64, JAX loops over frames in increasing t; here each
    sample takes its K = ceil(n_fft / hop) covering frames in that order."""
    *lead, n_frames, n_fft = ytmp.shape
    g = math.gcd(n_fft, hop)
    ratio = n_fft // g   # chunks per frame
    hb = hop // g        # blocks advanced per frame
    if ratio <= 64:
        blocks = ytmp.reshape(*lead, n_frames, ratio, g)
        n_blocks = max(-(-out_len // g), (n_frames - 1) * hb + ratio)
        acc = ytmp.new_zeros((*lead, n_blocks, g))
        for j in range(ratio):
            # frame t writes block t*hb + j
            acc[..., j:j + (n_frames - 1) * hb + 1:hb, :] += blocks[..., j, :]
        return acc.reshape(*lead, -1)[..., :out_len]
    total = (n_frames - 1) * hop + n_fft
    s = torch.arange(total, device=ytmp.device)
    t_last = torch.clamp(s // hop, max=n_frames - 1)
    t_first = torch.clamp(-((n_fft - 1 - s) // hop), min=0)  # ceil((s-n_fft+1)/hop)
    flat = ytmp.reshape(*lead, n_frames * n_fft)
    y = ytmp.new_zeros((*lead, total))
    for k in range(-(-n_fft // hop)):
        t = t_first + k
        valid = t <= t_last
        idx = torch.where(valid, t * n_fft + (s - t * hop), 0)
        y = y + torch.where(valid, flat[..., idx], 0.0)
    return fix_length(y, out_len)


def _istft_frames(mat, n_fft_padded: int, n_fft: int, window):
    """Denormalised irfft of (..., F, T) cropped to the analysis frame and
    windowed: (..., T, n_fft)."""
    mat = mat * math.sqrt(n_fft)  # denormalize
    # with zeropad the inverse frame is the zero-padded analysis frame, so
    # crop to n_fft (fourier.py:204-207)
    ytmp = torch.fft.irfft(mat, n=n_fft_padded, dim=-2)[..., :n_fft, :]
    return ytmp.transpose(-1, -2) * window


def istft(stft_matrix, hop_length=None, win_length=None, window_name="blackmanharris",
          center=True, length=None, zeropad=1, device="cuda"):
    """Inverse STFT (least-squares overlap-add, fourier.py:183-255).

    ``stft_matrix``: complex (n_freqs, n_frames), or (..., n_freqs, n_frames)
    inverted row by row; a tensor keeps its device, a host array is uploaded
    to ``device``.  Frame trimming for a target ``length`` matches the
    reference; ``zeropad`` inverts spectra of ``stft(..., zeropad=k)``."""
    mat = as_device_tensor(stft_matrix, device)
    if not mat.is_complex():
        mat = mat.to(torch.complex64)
    n_fft_padded = 2 * (mat.shape[-2] - 1)
    n_fft = n_fft_padded // int(zeropad)
    if win_length is None:
        win_length = n_fft
    if hop_length is None:
        hop_length = int(win_length // 4)
    hop_length, win_length = int(hop_length), int(win_length)
    if length:
        padded_length = length + n_fft if center else length
        n_frames = min(mat.shape[-1], int(np.ceil(padded_length / hop_length)))
    else:
        n_frames = mat.shape[-1]
    window = torch.as_tensor(pad_center(get_window(window_name, win_length), n_fft),
                             device=mat.device)
    ytmp = _istft_frames(mat[..., :n_frames], n_fft_padded, n_fft, window)
    expected_len = n_fft + hop_length * (n_frames - 1)
    y = _overlap_add(ytmp, hop_length, expected_len)
    wss = window_sumsquare(window_name, n_frames, hop_length=hop_length,
                           win_length=win_length, n_fft=n_fft)
    denom = np.where(wss > np.finfo(np.float32).tiny, wss, np.float32(1.0))
    y = y / torch.as_tensor(denom, device=y.device)
    if length is None:
        if center:
            y = y[..., n_fft // 2: expected_len - n_fft // 2]
        return y
    start = n_fft // 2 if center else 0
    return fix_length(y[..., start:], int(length))


def istft_frames_raw(stft_matrix, hop: int, window_name: str = "blackmanharris",
                     zeropad: int = 1):
    """UNNORMALISED inverse STFT of a tensor (fourier.py:258-278): irfft,
    synthesis window and overlap-add, without the window-sumsquare division
    or any trimming.  (n_freqs, n_frames) or (C, n_freqs, n_frames) ->
    (..., n_fft + hop*(n_frames-1)) in overlap-add coordinates (frame 0
    starts at 0).  The streamed engine divides by its own envelope."""
    n_fft_padded = 2 * (stft_matrix.shape[-2] - 1)
    n_fft = n_fft_padded // int(zeropad)
    n_frames = stft_matrix.shape[-1]
    window = torch.as_tensor(pad_center(get_window(window_name, n_fft), n_fft),
                             device=stft_matrix.device)
    ytmp = _istft_frames(stft_matrix, n_fft_padded, n_fft, window)
    return _overlap_add(ytmp, int(hop), n_fft + int(hop) * (n_frames - 1))


def fix_length(data, size: int, axis: int = -1):
    """Trim or zero-pad ``data`` to ``size`` along ``axis`` (fourier.py:440-478):
    a tensor stays a tensor on its device, anything else becomes numpy."""
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    n = data.shape[axis]
    if n > size:
        sl = [slice(None)] * data.ndim
        sl[axis] = slice(0, size)
        return data[tuple(sl)]
    if n < size:
        if isinstance(data, torch.Tensor):
            shape = list(data.shape)
            shape[axis] = size - n
            return torch.cat([data, data.new_zeros(shape)], dim=axis)
        lengths = [(0, 0)] * data.ndim
        lengths[axis] = (0, size - n)
        return np.pad(data, lengths)
    return data
