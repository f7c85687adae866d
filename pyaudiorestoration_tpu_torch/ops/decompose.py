"""Harmonic/percussive separation (HPSS) and soft masks (counterpart of
pyaudiorestoration_tpu/ops/decompose.py; reference: util/decompose.py,
librosa-derived, Fitzgerald 2010 / Driedger 2014).

The median filter is a selection, so it gives JAX's values exactly: the
windows are ``unfold(-1, size, 1)`` views of a padded copy and the median is
the middle element of each, tiled over the other axis (``block`` rows at a
time) to bound the (rows, n, size) working set.  The padding is scipy's
'reflect' mode, which is numpy's ``symmetric`` (the edge sample repeats):
``F.pad(mode="reflect")`` is numpy's ``reflect`` and does not repeat it, so
the pad is built from an index map.  Every function takes a leading batch
of channels: HPSS of (C, F, T) runs all channels in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import as_device_tensor

__all__ = ["softmask", "median_filter_1d", "harmonic", "magphase", "hpss"]

_TINY = float(np.finfo(np.float32).tiny)


def _symmetric_pad(x, pad_lo: int, pad_hi: int):
    """``np.pad(x, (pad_lo, pad_hi), mode="symmetric")`` over the last axis,
    for pads of any length (period 2n)."""
    n = x.shape[-1]
    i = torch.remainder(torch.arange(-pad_lo, n + pad_hi, device=x.device), 2 * n)
    return x[..., torch.where(i >= n, 2 * n - 1 - i, i)]


def _median_last_axis(x, size: int):
    """Sliding median of odd ``size`` along the last axis of (rows, n)."""
    pad_lo = size // 2
    windows = _symmetric_pad(x, pad_lo, size - 1 - pad_lo).unfold(-1, size, 1)
    return torch.sort(windows, dim=-1).values[..., size // 2]


def median_filter_1d(x, size: int, axis: int, block: int = 128, device="cuda"):
    """Median filter of odd ``size`` along ``axis`` of ``x`` (any rank), with
    scipy.ndimage's 'reflect' edges, tiled ``block`` rows at a time."""
    if size % 2 != 1:
        raise ValueError("median_filter_1d expects an odd kernel")
    x = as_device_tensor(x, device)
    moved = torch.movedim(x, axis, -1)
    shape = moved.shape
    rows = moved.reshape(-1, shape[-1])
    out = torch.cat([_median_last_axis(rows[a:a + block], size)
                     for a in range(0, rows.shape[0], block)])
    return torch.movedim(out.reshape(shape), -1, axis)


def softmask(X, X_ref, power=1, split_zeros=False, device="cuda"):
    """Numerically robust soft mask ``X**p / (X**p + X_ref**p)``
    (decompose.py:7-73); ``power=inf`` gives a hard mask ``X > X_ref``."""
    X = as_device_tensor(X, device)
    X_ref = as_device_tensor(X_ref, device).to(X.device)
    if X.shape != X_ref.shape:
        raise ValueError(f"Shape mismatch: {tuple(X.shape)} != {tuple(X_ref.shape)}")
    if np.isinf(power):
        return (X > X_ref).to(X.dtype)
    dtype = X.dtype if X.is_floating_point() else torch.float32
    Z = torch.maximum(X, X_ref).to(dtype)
    bad = Z < _TINY
    Zs = torch.where(bad, torch.ones_like(Z), Z)
    m = (X / Zs) ** power
    ref_m = (X_ref / Zs) ** power
    mask = m / (m + ref_m)
    return torch.where(bad, torch.full_like(mask, 0.5 if split_zeros else 0.0), mask)


def magphase(D, power=1, device="cuda"):
    """Magnitude**power and unit phasor ``D / max(|D|, tiny)`` of a complex
    spectrogram (decompose.py:152-174)."""
    D = as_device_tensor(D, device)
    mag = torch.abs(D)
    return mag ** power, D / torch.clamp(mag, min=_TINY)


def hpss(S, kernel_size=31, power=2.0, mask=False, margin=1.0, device="cuda"):
    """Median-filtering HPSS (decompose.py:177-271) of a (..., freq, time)
    magnitude or complex spectrogram: the harmonic median runs along time,
    the percussive one along frequency.  Returns (harmonic, percussive)
    components (or masks)."""
    S = as_device_tensor(S, device)
    if S.is_complex():
        S, phase = magphase(S)
    else:
        phase = 1
    win_harm, win_perc = ((kernel_size, kernel_size) if np.isscalar(kernel_size)
                          else kernel_size)
    margin_harm, margin_perc = (margin, margin) if np.isscalar(margin) else margin
    if margin_harm < 1 or margin_perc < 1:
        raise ValueError("Margins must be >= 1.0")
    harm = median_filter_1d(S, int(win_harm), axis=-1)   # along time
    perc = median_filter_1d(S, int(win_perc), axis=-2)   # along frequency
    split_zeros = margin_harm == 1 and margin_perc == 1
    mask_harm = softmask(harm, perc * margin_harm, power=power, split_zeros=split_zeros)
    mask_perc = softmask(perc, harm * margin_perc, power=power, split_zeros=split_zeros)
    if mask:
        return mask_harm, mask_perc
    return (S * mask_harm) * phase, (S * mask_perc) * phase


def harmonic(S, kernel_size=31, power=2.0, mask=False, margin=1.0, device="cuda"):
    """Harmonic component only (decompose.py:76-149)."""
    h, _ = hpss(S, kernel_size=kernel_size, power=power, mask=mask, margin=margin,
                device=device)
    return h
