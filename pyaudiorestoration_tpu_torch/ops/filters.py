"""Zero-phase IIR filtering (counterpart of pyaudiorestoration_tpu/ops/filters.py).

Butterworth low/high/band-pass chosen by which cutoffs lie in (0, nyquist),
applied forward and backward (``sosfiltfilt``), and a cumsum moving average.

Device form: each biquad's Direct Form II transposed recurrence
``s_n = A s_{n-1} + B x_n`` (A = [[-a1, 1], [-a2, 0]], B = [b1 - a1 b0,
b2 - a2 b0]; ``y_n = b0 x_n + s0_{n-1}``) runs as a log-depth doubling scan
over the affine state maps, in float64.  The matrix is the same at every
step, so the map composed over a span of d samples is ``A**d`` (a 2x2 host
constant) and each doubling step is ``v_n += A**d v_{n-d}``: elementwise
torch ops, about 12 launches a step and ``log2(n)`` steps a section.  The
JAX package runs the scan in float32 and refines it with error-free
transforms because the TPU has no float64; the card has float64, so the
scan simply runs in it and meets the same gate (> 100 dB against scipy's
float64 ``sosfiltfilt``).

``backend="host"`` calls scipy (float64, bit-equal to the JAX package's
host backend); the marker curves use it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _dsp

from ..utils.device import as_device_tensor

__all__ = ["butter_bandpass_filter", "sosfiltfilt", "sosfilt", "moving_average",
           "make_odd"]


@functools.lru_cache(maxsize=256)
def _design_butter(lowcut: float, highcut: float, fs: float, order: int):
    """Reference's band selection logic (filters.py:7-24).  Returns sos or None."""
    nyq = 0.5 * fs
    low = lowcut / nyq
    high = highcut / nyq
    low_ok = 0 < low < 1
    high_ok = 0 < high < 1
    if low_ok and high_ok:
        sos = _dsp.butter(order, [low, high], btype="band", output="sos")
    elif low_ok:
        sos = _dsp.butter(order, low, btype="high", output="sos")
    elif high_ok:
        sos = _dsp.butter(order, high, btype="low", output="sos")
    else:
        return None
    return np.asarray(sos, dtype=np.float64)


def _matrix_powers(a1: float, a2: float, n: int):
    """Host float64 ``A**(2**j)`` for every doubling step over ``n`` samples."""
    A = np.array([[-a1, 1.0], [-a2, 0.0]], np.float64)
    out, d = [], 1
    while d < n:
        out.append((d, A.copy()))
        A = A @ A
        d *= 2
    return out


def _section_scan(x, b0, b1, b2, a1, a2, zi):
    """One biquad over the last axis of ``x`` by the doubling scan, in the
    dtype of ``x``.  ``zi``: (..., 2) DF2T initial state.  Returns y."""
    B0, B1 = b1 - a1 * b0, b2 - a2 * b0
    v0, v1 = x * B0, x * B1
    if x.shape[-1]:
        # fold the initial state into the first step: s_0 = A zi + B x_0
        v0[..., 0] += -a1 * zi[..., 0] + zi[..., 1]
        v1[..., 0] += -a2 * zi[..., 0]
    for d, P in _matrix_powers(a1, a2, x.shape[-1]):
        (m00, m01), (m10, m11) = P.tolist()
        p0 = F.pad(v0[..., :-d], (d, 0))
        p1 = F.pad(v1[..., :-d], (d, 0))
        v0, v1 = v0 + m00 * p0 + m01 * p1, v1 + m10 * p0 + m11 * p1
    s_prev0 = torch.cat([zi[..., :1], v0[..., :-1]], dim=-1)
    return b0 * x + s_prev0


def _cascade(x, sos, zi):
    for k in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (float(v) for v in sos[k])
        x = _section_scan(x, b0, b1, b2, a1, a2, zi[..., k, :])
    return x


def sosfilt(sos, x, zi=None, device="cuda"):
    """Cascaded biquad filtering along the last axis (the float64 doubling
    scan).  ``sos``: (n_sections, 6) host array; ``zi``: (n_sections, 2)
    initial conditions in scipy's sosfilt convention.  ``x``: a tensor
    (which keeps its device) or a host array (uploaded to ``device``).
    Returns float32."""
    sos = np.asarray(sos, np.float64)
    x = as_device_tensor(x, device)
    if zi is None:
        zi = np.zeros((sos.shape[0], 2))
    zi = torch.as_tensor(np.asarray(zi, np.float64), device=x.device)
    return _cascade(x.to(torch.float64), sos, zi).to(torch.float32)


def sosfiltfilt(sos, x, padlen=None, compensated: bool = True, device="cuda"):
    """Zero-phase forward-backward filter on the device (scipy's default
    'pad' method: odd extension by ``padlen`` at both ends, ``sosfilt_zi``
    scaled by each pass's first input sample, forward then backward).

    ``compensated=True`` (default) runs the scan in float64, which holds the
    result above 100 dB against scipy's float64 ``sosfiltfilt`` on the
    narrowband cascades where the JAX package needs its error-free-transform
    refinement (the name is kept from there).  ``False`` runs it in float32
    (~40-55 dB on narrowband cascades, as the JAX package's plain scan).
    A float64 ``x`` enters the float64 scan unrounded; anything else is
    taken as float32.  Returns float32, shaped like ``x``."""
    sos = np.asarray(sos, dtype=np.float64)
    x = as_device_tensor(x, device)
    if x.dtype != torch.float64:
        x = x.to(torch.float32)
    if padlen is None:
        # scipy's sosfiltfilt edge formula (first-order sections shorten it)
        ntaps = 2 * sos.shape[0] + 1
        ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
        padlen = 3 * int(ntaps)
    padlen = min(padlen, x.shape[-1] - 1)
    dt = torch.float64 if compensated else torch.float32
    zi = torch.as_tensor(_dsp.sosfilt_zi(sos), dtype=dt, device=x.device)
    xs = x.to(dt)
    n = xs.shape[-1]
    left = 2 * xs[..., :1] - torch.flip(xs[..., 1:padlen + 1], dims=(-1,))
    right = 2 * xs[..., -1:] - torch.flip(xs[..., n - padlen - 1:n - 1], dims=(-1,))
    ext = torch.cat([left, xs, right], dim=-1)

    def run(sig):
        # scipy's sosfilt_zi folds in the cumulative section gain, so every
        # section's state is scaled by the pass's first input sample
        return _cascade(sig, sos, zi * sig[..., :1, None])

    fwd = run(ext)
    bwd = torch.flip(run(torch.flip(fwd, dims=(-1,))), dims=(-1,))
    return bwd[..., padlen:padlen + n].to(torch.float32)


def _sosfiltfilt_host_zi(sos, x):
    """scipy path, exact reference parity (float64)."""
    return _dsp.sosfiltfilt(sos, np.asarray(x)).astype(np.float32)


def butter_bandpass_filter(data, lowcut, highcut, fs, order=5, backend="device",
                           device="cuda"):
    """Low/high/band-pass depending on which cutoffs are valid (filters.py:7-24).

    ``backend="device"`` runs :func:`sosfiltfilt` and returns a tensor;
    ``backend="host"`` calls scipy (float64) and returns numpy.  ``data`` is
    returned unchanged when neither cutoff lies inside (0, nyquist)."""
    sos = _design_butter(float(lowcut), float(highcut), float(fs), int(order))
    if sos is None:
        return data
    if backend == "host":
        return _sosfiltfilt_host_zi(sos, data)
    return sosfiltfilt(sos, data, device=device)


def moving_average(a, n=3):
    """Trailing moving average, length len(a)-n+1 (filters.py:27-30).  A
    tensor is averaged in float32 on its device, anything else in float64
    on the host."""
    if isinstance(a, torch.Tensor):
        ret = torch.cumsum(a.to(torch.float32), dim=0)
        ret = torch.cat([ret[:n], ret[n:] - ret[:-n]])
        return ret[n - 1:] / n
    ret = np.cumsum(a, dtype=float)
    ret[n:] = ret[n:] - ret[:-n]
    return ret[n - 1:] / n


def make_odd(n):
    return n if n % 2 else n + 1
