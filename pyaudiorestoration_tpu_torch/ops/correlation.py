"""FFT cross-correlation and sub-sample parabolic refinement (counterpart of
pyaudiorestoration_tpu/ops/correlation.py).

Normalised correlation of unit-energy inputs, scipy's 'full' / 'same' /
'valid' layouts, the quadratic peak interpolation, and the delay estimator
``find_delay`` with its batched form ``find_delay_batch`` (one call for a
stack of windows, as tapesync's alignment needs).
"""

from __future__ import annotations

import torch

from ..utils.device import as_device_tensor
from .fourier import get_window

__all__ = ["xcorr", "find_delay", "find_delay_batch", "parabolic", "parabolic_batch"]


def _next_fast_len(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def parabolic(f, x):
    """Quadratic-interpolate the peak at integer index ``x`` of the 1-D
    tensor ``f``.  Returns (refined_index, refined_value) (correlation.py:42-46)."""
    fm1, f0, fp1 = f[x - 1], f[x], f[x + 1]
    denom = fm1 - 2 * f0 + fp1
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-12), denom)
    xv = 0.5 * (fm1 - fp1) / denom + x
    yv = f0 - 0.25 * (fm1 - fp1) * (xv - x)
    return xv, yv


def parabolic_batch(f: torch.Tensor, x: torch.Tensor):
    """Quadratic-interpolate the peak of ``f`` (..., n) at integer indices
    ``x`` (...).  Returns (refined_index, refined_value) (correlation.py:42-46)."""
    fm1 = torch.gather(f, -1, (x - 1).unsqueeze(-1)).squeeze(-1)
    f0 = torch.gather(f, -1, x.unsqueeze(-1)).squeeze(-1)
    fp1 = torch.gather(f, -1, (x + 1).unsqueeze(-1)).squeeze(-1)
    denom = fm1 - 2 * f0 + fp1
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-12), denom)
    xv = 0.5 * (fm1 - fp1) / denom + x
    yv = f0 - 0.25 * (fm1 - fp1) * (xv - x)
    return xv, yv


def _correlate_full(a, b):
    """FFT correlation over the last axis, 'full' layout: lags
    -(len(b)-1) .. len(a)-1, the FFT length padded to a power of two."""
    la, lb = a.shape[-1], b.shape[-1]
    n = _next_fast_len(la + lb - 1)
    fa = torch.fft.rfft(a, n=n)
    fb = torch.fft.rfft(b, n=n)
    cc = torch.fft.irfft(fa * torch.conj(fb), n=n)
    # circular lags: index k holds lag k for k < la, lag k-n for k >= n-lb+1
    neg = cc[..., n - (lb - 1):] if lb > 1 else cc[..., :0]
    return torch.cat([neg, cc[..., :la]], dim=-1)


def xcorr(a, b, mode: str = "full"):
    """Normalised cross correlation in [-1, 1] over the last axis of two
    tensors (correlation.py:6-13)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    full = _correlate_full(a, b)
    la, lb = a.shape[-1], b.shape[-1]
    if mode == "full":
        return full
    if mode == "same":
        # scipy: same size as a, centred with respect to 'full'
        start = (full.shape[-1] - la) // 2
        return full[..., start:start + la]
    if mode == "valid":
        start = min(la, lb) - 1
        return full[..., start:start + max(la, lb) - min(la, lb) + 1]
    raise ValueError(mode)


def _find_delay_core(a, b, ignore_phase: bool, window_name):
    """Delay of each row of ``b`` against ``a`` (B, n), in samples, with the
    peak correlation (correlation.py:91-107): the argmax is clamped to
    [1, n-2] so the 3-point parabola stays in range."""
    if window_name:
        a = a * torch.as_tensor(get_window(window_name, a.shape[-1]), device=a.device)
        b = b * torch.as_tensor(get_window(window_name, b.shape[-1]), device=b.device)
    res = xcorr(a, b, mode="same")
    max_index = torch.argmax(torch.abs(res) if ignore_phase else res, dim=-1)
    max_index = torch.clamp(max_index, 1, res.shape[-1] - 2)
    i_peak, corr = parabolic_batch(res, max_index)
    return i_peak - res.shape[-1] // 2, corr


def find_delay(a, b, ignore_phase: bool = False, window_name=None, device="cuda"):
    """Delay between 1-D signals a and b in samples, and their correlation
    (correlation.py:110-114).  Tensors keep their device; host arrays are
    uploaded to ``device``.  Returns two 0-d tensors."""
    a = as_device_tensor(a, device, torch.float32)
    b = as_device_tensor(b, device, torch.float32).to(a.device)
    d, c = _find_delay_core(a[None, :], b[None, :], bool(ignore_phase), window_name)
    return d[0], c[0]


def find_delay_batch(a, b, ignore_phase: bool = False, window_name=None, device="cuda"):
    """Batched delay estimation over (batch, n) stacks in one call
    (correlation.py:117-123).  Returns (delays, corrs), each (batch,)."""
    a = as_device_tensor(a, device, torch.float32)
    b = as_device_tensor(b, device, torch.float32).to(a.device)
    return _find_delay_core(a, b, bool(ignore_phase), window_name)
