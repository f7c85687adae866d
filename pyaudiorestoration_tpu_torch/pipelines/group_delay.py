"""Per-band phase / group delay estimation between two recordings
(counterpart of pyaudiorestoration_tpu/pipelines/group_delay.py; reference:
experiments/group_delay.py).

The reference loops log-spaced bands, band-passing both signals with scipy
and cross-correlating each pair.  Here every band comes at once from
frequency-domain band filtering (one rFFT per signal and the bands'
zero-phase Butterworth magnitude responses), and all bands are correlated
in one batched ``find_delay_batch``; only the lags, correlations and band
levels leave the device.  The responses are evaluated on the device in
float64 (JAX calls scipy's ``sosfreqz`` per band on the host, ~0.3 s a band
at 2**21 bins).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from scipy import signal as _dsp

from ..ops import correlation
from ..utils.device import resolve_device

__all__ = ["band_delays"]


def _pairwise(it):
    a, b = itertools.tee(it)
    next(b, None)
    return zip(a, b)


def _band_responses(sos_stack, n_fft: int, device):
    """|H|^2 of each band's second-order sections at the rFFT bins of
    ``n_fft`` (``sosfreqz``'s response, zero phase as filtfilt's), in
    float64 on ``device``, cast to float32: (num_bands, n_fft // 2 + 1).
    ``sos_stack``: (num_bands, sections, 6) host array, a0 = 1."""
    sos = torch.as_tensor(np.asarray(sos_stack, np.float64), device=device)
    w = 2 * np.pi * torch.arange(n_fft // 2 + 1, dtype=torch.float64, device=device) / n_fft
    c1, s1, c2, s2 = torch.cos(w), torch.sin(w), torch.cos(2 * w), torch.sin(2 * w)
    power = torch.ones((sos.shape[0], w.shape[0]), dtype=torch.float64, device=device)
    for k in range(sos.shape[1]):
        b0, b1, b2, _, a1, a2 = (sos[:, k, i, None] for i in range(6))
        num = (b0 + b1 * c1 + b2 * c2) ** 2 + (b1 * s1 + b2 * s2) ** 2
        den = (1 + a1 * c1 + a2 * c2) ** 2 + (a1 * s1 + a2 * s2) ** 2
        power = power * (num / den)
    return power.to(torch.float32)


def _bandify(x, H, n: int, n_fft: int):
    """Apply a stack of zero-phase band responses ``H`` (num_bands, n_rfft)
    to the 1-D ``x``.  ``n_fft`` is the power of two >= n that JAX uses: the
    zero padding also removes circular wrap-around from the band filtering,
    so the lags depend on it."""
    X = torch.fft.rfft(x, n=n_fft)
    return torch.fft.irfft(X[None, :] * H, n=n_fft)[:, :n]


def band_delays(ref_sig, src_sig, sr, f_lower=10.0, f_upper=2000.0, bandwidth=45.0,
                order=1, min_corr=0.6, device="cuda"):
    """Delay and correlation per log-spaced band (group_delay.py:31-110).

    Returns a list of dicts: band centre, lag (samples), correlation, and the
    per-band ref/src RMS levels (for differential-EQ style diagnostics)."""
    dev = resolve_device(device)
    n = min(len(ref_sig), len(src_sig))
    n_fft = 1 << (n - 1).bit_length()
    num_bands = int((f_upper - f_lower) / bandwidth)
    band_limits = np.logspace(np.log2(f_lower), np.log2(f_upper), num=num_bands,
                              endpoint=True, base=2)
    pairs = list(_pairwise(band_limits))
    centers = [(lo + hi) / 2 for lo, hi in pairs]
    H = _band_responses([_dsp.butter(order, [lo / (sr / 2), hi / (sr / 2)], btype="band",
                                     output="sos") for lo, hi in pairs], n_fft, dev)
    bands = [_bandify(torch.as_tensor(np.asarray(s[:n], np.float32), device=dev), H, n,
                      n_fft) for s in (ref_sig, src_sig)]
    delays, corrs = correlation.find_delay_batch(*bands)
    ref_rms, src_rms = (torch.sqrt(torch.mean(torch.square(b), dim=1)).cpu().numpy()
                        for b in bands)
    out = []
    for c, d, corr, rv, sv in zip(centers, delays.cpu().numpy(), corrs.cpu().numpy(),
                                  ref_rms, src_rms):
        if corr > min_corr:
            out.append({"band_hz": float(c), "lag_samples": float(d), "corr": float(corr),
                        "ref_rms": float(rv), "src_rms": float(sv)})
    return out
