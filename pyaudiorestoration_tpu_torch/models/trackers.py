"""Wow/flutter pitch trackers (counterpart of pyaudiorestoration_tpu/models/trackers.py).

Stateless functions sharing one registry (``wow_detectors``), as in the JAX
package:

* ``Peak`` / ``Peak Track``: one masked argmax plus parabolic refinement
  over every frame at once (``masked_peak_refine``); ``Peak`` with an
  ``adaptation_mode`` predicts each frame's band from the last four peaks.
* ``Center of Gravity``: sequential band adaptation (Czyzewski et al. 2007).
* ``Zero-Crossing``: device band-pass, then crossings on the host.
* ``Correlation``: per-frame log2-frequency resample and the xcorr of
  consecutive frames.
* ``Freehand Draw``: the drawn trail as it is.
* ``fit_sin`` / ``trace_sine_reg``: host float64 sine regression.

The two sequential trackers (the adaptive peak and the centre of gravity)
are ``lax.scan``s in JAX; here they are a loop over frames of small torch
ops on the spectrum's device, the carry staying on the device (no host
round trip per frame).  Each issues tens of launches a frame, so they are
launch-bound on the card.

Every tracker takes a magnitude spectrogram ``spectrum`` (num_bins,
num_frames) as a host array or tensor, the raw ``signal`` (frames, channels)
and the ``trail`` of (time, freq) pairs, plus ``device`` ("cuda" by
default; a tensor spectrum keeps its own), and returns host ``(times,
freqs)`` numpy arrays.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.signal import get_window

from ..ops import filters
from ..ops.correlation import parabolic_batch, xcorr
from ..utils.device import as_device_tensor

MIN_BINS = 4

__all__ = ["wow_detectors", "trace", "fit_sin", "trace_sine_reg", "interp_nans",
           "nan_helper", "masked_peak_refine", "adapt_band", "trace_partials",
           "interp_rows"]


def nan_helper(y):
    return np.isnan(y), lambda z: z.nonzero()[0]


def interp_nans(y):
    """In-place linear interpolation over NaN runs (wow_detection.py:14-22)."""
    nans, x = nan_helper(y)
    if nans.any() and (~nans).any():
        y[nans] = np.interp(x(nans), x(~nans), y[~nans])
    return y


class _Grid:
    """Shared trail sampling / unit mapping (wow_detection.py:28-117)."""

    def __init__(self, spectrum, fft_size, hop, sr, tolerance_st=1.0):
        self.fft_size = int(fft_size)
        self.hop = int(hop)
        self.sr = int(sr)
        self.num_bins, self.num_frames = spectrum.shape
        self.tolerance = tolerance_st / 12.0

    def time_2_frame(self, t):
        return int(t * self.sr / self.hop)

    def sample_trail(self, trail):
        trail = sorted(trail, key=lambda tup: tup[0])
        times_raw = [d[0] for d in trail]
        freqs_raw = [d[1] for d in trail]
        frame_0, frame_1 = 0, self.num_frames
        if times_raw[0]:
            frame_0 = max(frame_0, self.time_2_frame(times_raw[0]))
        if times_raw[-1]:
            frame_1 = min(frame_1, self.time_2_frame(times_raw[-1]))
        if frame_0 == frame_1:
            logging.warning("No point in tracing just one FFT")
        times = np.linspace(frame_0 * self.hop / self.sr, frame_1 * self.hop / self.sr,
                            frame_1 - frame_0)
        freqs = np.interp(times, times_raw, freqs_raw)
        return frame_0, frame_1, times, freqs


def _band_limits_np(freqs, tolerance, fft_size, sr, num_bins):
    """Vectorized band limits with the reference's min-bin widening
    (wow_detection.py:97-117)."""
    logf = np.log2(freqs)
    fL = np.clip(np.power(2.0, logf - tolerance), 1.0, None)
    fU = np.minimum(np.power(2.0, logf + tolerance), sr / 2)
    NL = np.clip(np.round(fL * fft_size / sr).astype(np.int32), 1, num_bins - 1)
    NU = np.clip(np.round(fU * fft_size / sr).astype(np.int32), 1, num_bins - 1)
    width = NU - NL
    iters = np.where(width < MIN_BINS, (MIN_BINS - width + 1) // 2, 0)
    return NL - iters, NU + iters


def _frames_on_device(spectrum, lo, hi, frame_0, frame_1, device):
    """Frames ``frame_0:frame_1`` of bins ``lo:hi`` of a (num_bins,
    num_frames) spectrum as a contiguous (T, bins) float32 tensor (a host
    spectrum stored frame-major, as ``compute_spectrum`` returns it, uploads
    without a copy)."""
    sel = spectrum[lo:hi, frame_0:frame_1].T
    if isinstance(sel, torch.Tensor):
        return sel.to(torch.float32).contiguous()
    return as_device_tensor(np.ascontiguousarray(sel, dtype=np.float32), device)


def masked_peak_refine(frames: torch.Tensor, nl: torch.Tensor, nu: torch.Tensor,
                       bin_offset: float = 0.0) -> torch.Tensor:
    """Per frame, argmax within [nl, nu) (the first index on ties), parabolic
    refinement where the maximum is strictly above both neighbours, the raw
    bin otherwise (wow_detection.py:119-139).

    ``frames``: (..., T, F) magnitudes; ``nl``/``nu``: (..., T) int bands.
    Returns the refined peak bin as float32, plus ``bin_offset``."""
    F = frames.shape[-1]
    bins = torch.arange(F, device=frames.device)
    mask = (bins >= nl.unsqueeze(-1)) & (bins < nu.unsqueeze(-1))
    scores = torch.where(mask, frames, torch.full_like(frames, -torch.inf))
    peak = torch.argmax(scores, dim=-1)
    p = torch.clamp(peak, 1, F - 2)
    fm1 = torch.gather(frames, -1, (p - 1).unsqueeze(-1)).squeeze(-1)
    f0 = torch.gather(frames, -1, p.unsqueeze(-1)).squeeze(-1)
    fp1 = torch.gather(frames, -1, (p + 1).unsqueeze(-1)).squeeze(-1)
    is_peak = (fm1 < f0) & (f0 > fp1) & (peak == p)
    refined, _ = parabolic_batch(frames, p)
    out = torch.where(is_peak, refined, peak.to(refined.dtype))
    return out + bin_offset if bin_offset else out


def _masked_peak_per_frame(frames, NL, NU, fft_size: int, sr: int):
    """Peak bins -> Hz over (T, num_bins) frames."""
    return masked_peak_refine(frames, NL, NU) / fft_size * sr


def _trace_peak(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
                adaptation_mode="None", fixed_band=False, half_after=3,
                device="cuda"):
    g = _Grid(spectrum, fft_size, hop, sr, tolerance_st)
    frame_0, frame_1, times, freqs = g.sample_trail(trail)
    frames = _frames_on_device(spectrum, 0, g.num_bins, frame_0, frame_1, device)
    if not fixed_band and adaptation_mode in ("Constant", "Linear", "Average"):
        out = _trace_peak_adaptive(frames, freqs[0], g, adaptation_mode)
        interp_nans(out)
        return times, out
    if fixed_band:
        # 'Peak Track': the band comes from the first drawn frequency, with
        # the tolerance halved after the first ``half_after`` frames
        # (3 in the reference, wow_detection.py:311-327)
        tol = np.full(len(freqs), g.tolerance)
        tol[min(half_after, len(tol)):] = g.tolerance / 2
        NL, NU = _band_limits_np(np.full(len(freqs), freqs[0]), tol, g.fft_size, g.sr,
                                 g.num_bins)
    else:
        NL, NU = _band_limits_np(freqs, g.tolerance, g.fft_size, g.sr, g.num_bins)
    dev = frames.device
    out = _masked_peak_per_frame(frames, torch.as_tensor(NL, device=dev),
                                 torch.as_tensor(NU, device=dev), g.fft_size,
                                 g.sr).cpu().numpy()
    interp_nans(out)
    return times, out


def _adaptive_peak_scan(frames, carry0, tolerance_st, mode: str, fft_size: int,
                        sr: int):
    """Sequential adapt_band prediction + peak pick over (T, num_bins)
    ``frames``, one frame a step (the JAX ``lax.scan``); ``carry0``: the last
    4 traced log2 frequencies as 0-d float32 tensors.  Returns (T,) Hz."""
    hist = carry0
    out = []
    for t in range(frames.shape[0]):
        hist, freq = adaptive_step_core(frames[t], hist, tolerance_st, mode,
                                        fft_size, sr)
        out.append(freq)
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=frames.device)
    return torch.stack(out)


def adaptive_step_core(frame, hist, tolerance_st, mode: str, fft_size: int,
                       sr: int):
    """One adapt_band prediction + emphasized peak pick (wow_detection.py:
    142-187).  ``frame``: (num_bins,) magnitudes; ``hist``: 4-tuple of the
    last traced log2 frequencies (0-d float32 tensors).  Returns
    (new_hist, freq)."""
    num_bins = frame.shape[-1]
    bins = torch.arange(num_bins, dtype=torch.float32, device=frame.device)
    freq_2_bin = fft_size / sr
    l1, l2, l3, l4 = hist
    if mode == "Constant":
        logfreq = l4
    elif mode == "Linear":
        logfreq = l4 + (l4 - l2)
    else:  # Average
        logfreq = l1 + (l4 - l1) / 3.0 * 4.0
    tol = float(np.float32(tolerance_st) / np.float32(12.0))
    fL = torch.pow(2.0, logfreq - tol)
    fU = torch.pow(2.0, logfreq + tol)
    NL = torch.clamp(torch.round(fL * freq_2_bin).to(torch.int32), 1, num_bins - 3)
    NU = torch.clamp(torch.round(fU * freq_2_bin).to(torch.int32), 1, num_bins - 2)
    # triangular emphasis window peaked at the predicted frequency
    pb = torch.pow(2.0, logfreq) * freq_2_bin
    nlf, nuf = NL.to(torch.float32), NU.to(torch.float32)
    up = (bins - nlf) / torch.clamp(pb - nlf, min=1e-6)
    down = (nuf - 1.0 - bins) / torch.clamp(nuf - 1.0 - pb, min=1e-6)
    tri = torch.clamp(torch.minimum(up, down), 0.0, 1.0)
    window = torch.where(NU - NL > 5, tri, 1.0)
    mask = (bins >= nlf) & (bins < nuf)
    scores = torch.where(mask, frame * window, -torch.inf)
    peak = torch.argmax(scores, dim=-1)
    p = torch.clamp(peak, 1, num_bins - 2)
    fm1, f0, fp1 = frame[p - 1], frame[p], frame[p + 1]
    d = fm1 - 2 * f0 + fp1
    denom = torch.where(d == 0, 1e-12, d)
    refined = p.to(torch.float32) + 0.5 * (fm1 - fp1) / denom
    is_peak = (fm1 < f0) & (f0 > fp1) & (peak == p)
    peak_bin = torch.where(is_peak, refined, peak.to(torch.float32))
    # collapsed band (NU <= NL) -> hold the previous frequency instead of
    # emitting bin 0 and poisoning the history (the host warm loop's guard)
    band_ok = NU > NL
    freq = torch.where(band_ok, peak_bin / fft_size * sr, torch.pow(2.0, l4))
    lf = torch.where(band_ok, torch.log2(torch.clamp(freq, min=1e-12)), l4)
    return (l2, l3, l4, lf), freq


def _trace_peak_adaptive(frames, seed_freq, g, mode):
    """adapt_band-driven tracking over (T, num_bins) ``frames``: the first 4
    frames sequentially on the host (exact reference early-history
    slicing), then the device loop."""
    T = frames.shape[0]
    freq_2_bin = g.fft_size / g.sr
    freqs = [float(seed_freq)]
    warm = min(4, T)
    out = np.empty(T, dtype=np.float32)
    for t in range(warm):
        i = len(freqs) - 1
        NL, NU, window, _ = adapt_band(freqs, g.num_bins, freq_2_bin,
                                       g.tolerance * 12, mode, i)
        frame = frames[t].cpu().numpy()
        if NU <= NL:
            out[t] = freqs[-1]
            freqs.append(freqs[-1])
            continue
        scores = frame[NL:NU] * window
        peak = int(np.argmax(scores)) + NL
        p = min(max(peak, 1), g.num_bins - 2)
        fm1, f0, fp1 = frame[p - 1], frame[p], frame[p + 1]
        denom = fm1 - 2 * f0 + fp1 or 1e-12
        refined = p + 0.5 * (fm1 - fp1) / denom
        is_peak = (fm1 < f0) and (f0 > fp1) and (peak == p)
        peak_bin = refined if is_peak else float(peak)
        out[t] = peak_bin / g.fft_size * g.sr
        freqs.append(float(out[t]))
    if T > warm:
        hist = np.log2(np.maximum(freqs[-4:], 1e-12)).astype(np.float32)
        carry0 = tuple(torch.tensor(v, device=frames.device) for v in hist)
        out[warm:] = _adaptive_peak_scan(frames[warm:], carry0,
                                         np.float32(g.tolerance * 12), mode,
                                         g.fft_size, g.sr).cpu().numpy()
    return out


def trace_peak(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
               adaptation_mode="None", device="cuda"):
    return _trace_peak(spectrum, signal, trail, fft_size, hop, sr, tolerance_st,
                       adaptation_mode=adaptation_mode, device=device)


def trace_peak_track(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
                     adaptation_mode="None", device="cuda"):
    return _trace_peak(spectrum, signal, trail, fft_size, hop, sr, tolerance_st,
                       fixed_band=True, device=device)


def trace_freehand(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
                   adaptation_mode="None", device="cuda"):
    """Use the drawn trail verbatim (wow_detection.py:390-394)."""
    g = _Grid(spectrum, fft_size, hop, sr, tolerance_st)
    _, _, times, freqs = g.sample_trail(trail)
    return times, freqs


def cog_step_core(frame, NL, NU, log2_fft_freqs, tolerance, fft_size: int, sr: int):
    """One center-of-gravity step: masked-hann COG of ``frame`` within
    [NL, NU) plus the next band (freq_plus_tolerance + set_bin_limits with
    clamping and min-bin widening, wow_detection.py:256-291).  ``frame`` is
    (..., F) and ``NL``/``NU`` (...,) int32 tensors."""
    num_bins = frame.shape[-1]
    bins = torch.arange(num_bins, dtype=torch.float32, device=frame.device)
    NLf = NL[..., None].to(torch.float32)
    NUf = NU[..., None].to(torch.float32)
    w = torch.clamp(NUf - NLf, min=1.0)
    k = bins - NLf
    hann = 0.5 - 0.5 * torch.cos(2 * np.pi * k / torch.clamp(w - 1.0, min=1.0))
    mask = (bins >= NLf) & (bins < NUf)
    wm = torch.where(mask, hann * frame, 0.0)
    cog_log2 = torch.sum(wm * log2_fft_freqs, dim=-1) / torch.clamp(
        torch.sum(wm, dim=-1), min=1e-20)
    cog = torch.pow(2.0, cog_log2)
    tol = float(np.float32(tolerance))
    fL = torch.clamp(torch.pow(2.0, cog_log2 - tol), min=1.0)
    fU = torch.clamp(torch.pow(2.0, cog_log2 + tol), max=float(np.float32(sr / 2)))
    nl = torch.clamp(torch.round(fL * fft_size / sr).to(torch.int32), 1, num_bins - 1)
    nu = torch.clamp(torch.round(fU * fft_size / sr).to(torch.int32), 1, num_bins - 1)
    width = nu - nl
    iters = torch.where(width < MIN_BINS, (MIN_BINS - width + 1) // 2, 0)
    return nl - iters, nu + iters, cog


def _cog_scan(frames, log2_fft_freqs, NL0, NU0, tolerance, fft_size: int, sr: int):
    """Center-of-gravity tracking with sequential band adaptation over
    (T, num_bins) ``frames``, one frame a step; bands are masked
    continuous-hann windows over the full spectrum."""
    NL, NU = NL0, NU0
    cogs = []
    for t in range(frames.shape[0]):
        NL, NU, cog = cog_step_core(frames[t], NL, NU, log2_fft_freqs, tolerance,
                                    fft_size, sr)
        cogs.append(cog)
    if not cogs:
        return torch.zeros(0, dtype=torch.float32, device=frames.device)
    return torch.stack(cogs)


def trace_cog(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
              adaptation_mode="None", device="cuda"):
    g = _Grid(spectrum, fft_size, hop, sr, tolerance_st)
    frame_0, frame_1, times, freqs = g.sample_trail(trail)
    NL, NU = _band_limits_np(freqs[:1], g.tolerance, g.fft_size, g.sr, g.num_bins)
    from ..ops.fourier import fft_freqs
    # log2 of bin frequencies; bin 0 is DC -> -inf, masked out by NL >= 1
    with np.errstate(divide="ignore"):
        lff = np.log2(np.maximum(fft_freqs(g.fft_size, g.sr), 1e-12)).astype(np.float32)
    frames = _frames_on_device(spectrum, 0, g.num_bins, frame_0, frame_1, device)
    dev = frames.device
    cogs = _cog_scan(frames, torch.as_tensor(lff, device=dev),
                     torch.tensor(int(NL[0]), dtype=torch.int32, device=dev),
                     torch.tensor(int(NU[0]), dtype=torch.int32, device=dev),
                     g.tolerance, g.fft_size, g.sr).cpu().numpy()
    interp_nans(cogs)
    return times, cogs


def zero_crossings(a):
    positive = a > 0
    return np.where(np.bitwise_xor(positive[1:], positive[:-1]))[0]


def trace_zero_crossing(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
                        adaptation_mode="None", device="cuda"):
    """Zero-crossing distance pitch tracking (wow_detection.py:330-358); the
    band-pass runs on ``device`` (float64 scan), the crossings on the host."""
    g = _Grid(spectrum, fft_size, hop, sr, tolerance_st)
    _, _, times, freqs = g.sample_trail(trail)
    tol = g.tolerance
    fL = np.power(2.0, np.log2(np.min(freqs)) - tol)
    fU = np.power(2.0, np.log2(np.max(freqs)) + tol)
    s_0 = int(times[0] * sr)
    s_1 = int(times[-1] * sr)
    sig = signal[s_0:s_1, 0] if signal.ndim == 2 else signal[s_0:s_1]
    filtered = filters.butter_bandpass_filter(sig, fL, fU, sr, order=3, device=device)
    if isinstance(filtered, torch.Tensor):
        filtered = filtered.cpu().numpy()
    crossings = zero_crossings(np.asarray(filtered))
    deltas = np.diff(crossings).astype(np.float32)
    # PDM -> PCM: hann smoothing sized by the mean crossing distance
    size = int(sr / 100 / np.mean(deltas))
    padded = np.pad(deltas, size, mode="reflect")
    win = get_window("hann", size)
    deltas_conv = np.convolve(padded, win / size * 2, mode="same")[size:-size]
    out = np.interp(times, crossings[:len(deltas_conv)] / sr + times[0],
                    sr / 2 / deltas_conv)
    return times, out


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace`` in float32: ``start*(1-s) + stop*s`` with
    ``s = i/(num-1)``, the last point exactly ``stop``."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    div = np.float32(num - 1)
    s = np.arange(num - 1, dtype=np.float32) / div
    out = start * (np.float32(1) - s) + stop * s
    return np.concatenate([out, [stop]]).astype(np.float32)


def interp_rows(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` applied to every row of ``fp`` (R, n):
    linear between the points of the sorted grid ``xp`` (n,), ``fp[0]`` /
    ``fp[-1]`` held outside it.  ``searchsorted`` + lerp, as ``jnp.interp``
    computes it.  Returns (R, len(x))."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    f_lo, f_hi = fp[:, i - 1], fp[:, i]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, 1.0, dx)) * (f_hi - f_lo))
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def _correlation_changes(frames, log_lo, log_hi, num_freq_samples: int):
    """Per-frame log2-grid resample + consecutive-frame xcorr peak deltas
    over (T, n_bins) band ``frames``."""
    dev = frames.device
    n_bins = frames.shape[1]
    src_log = torch.as_tensor(_linspace_f32(log_lo, log_hi, n_bins), device=dev)
    dst_log = torch.as_tensor(_linspace_f32(log_lo, log_hi, num_freq_samples), device=dev)
    resampled = interp_rows(dst_log, src_log, frames)  # (T, F)
    wind = torch.as_tensor(np.hanning(num_freq_samples).astype(np.float32), device=dev)
    a = resampled[:-1] * wind
    b = resampled[1:] * wind
    res = xcorr(a, b, mode="same")
    i_peak = torch.clamp(torch.argmax(res, dim=-1), 1, res.shape[-1] - 2)
    i_interp, _ = parabolic_batch(res, i_peak)
    return (num_freq_samples // 2) - i_interp


def trace_correlation(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
                      adaptation_mode="None", device="cuda"):
    """Spectral-flow speed tracking (wow_detection.py:396-436): a linear
    log2-grid resample of each frame and the xcorr of consecutive frames."""
    g = _Grid(spectrum, fft_size, hop, sr, tolerance_st)
    frame_0, frame_1, times, freqs = g.sample_trail(trail)
    fL, fU = float(np.min(freqs)), float(np.max(freqs))
    # the reference sets limits from the raw fL/fU (no tolerance applied)
    NL = max(1, min(g.num_bins - 1, int(round(fL * g.fft_size / g.sr))))
    NU = max(1, min(g.num_bins - 1, int(round(fU * g.fft_size / g.sr))))
    while NU - NL < MIN_BINS:
        NL -= 1
        NU += 1
    num_freq_samples = (NU - NL) * 4
    from ..ops.fourier import fft_freqs
    lff = np.log2(fft_freqs(g.fft_size, g.sr)[NL:NU])
    frames = _frames_on_device(spectrum, NL, NU, frame_0, frame_1, device)
    n = frame_1 - frame_0
    changes = np.ones(n)
    changes[:n - 1] = _correlation_changes(
        frames, float(lff[0]), float(lff[-1]), num_freq_samples).cpu().numpy()[:n - 1]
    speed = np.cumsum(changes)
    speed = speed / num_freq_samples * (lff[-1] - lff[0])
    log_mean = np.log2((fL + fU) / 2)
    return times, np.power(2.0, log_mean + speed)


def adapt_band(freqs, num_bins, freq_2_bin, tolerance, adaptation_mode, i):
    """Predict the next detection band from recent peaks
    (wow_detection.py:142-187; UI-hidden in the reference).

    Returns (NL, NU, window, logfreq): bin limits, a triangular emphasis
    window over the band, and the predicted log2 frequency.
    """
    logfreq = np.log2(freqs[i])
    if adaptation_mode in ("None", "Constant"):
        pass
    elif adaptation_mode == "Linear":
        if len(freqs) > 1:
            delta = logfreq - np.log2(freqs[i - 2])
            logfreq += delta
    elif adaptation_mode == "Average":
        logfreqs = np.log2(freqs[max(0, i - 3):i + 1])
        deltas = np.diff(logfreqs)
        logfreq = logfreqs[0]
        if len(deltas):
            logfreq += np.nanmean(deltas) * len(logfreqs)
    fL = np.power(2, (logfreq - tolerance / 12))
    fU = np.power(2, (logfreq + tolerance / 12))
    NL = max(1, min(num_bins - 3, int(round(fL * freq_2_bin))))
    NU = min(num_bins - 2, max(1, int(round(fU * freq_2_bin))))
    if NU - NL > 5:
        window = np.interp(np.arange(NL, NU),
                           (NL, np.power(2, logfreq) * freq_2_bin, NU - 1), (0, 1, 0))
    else:
        window = np.ones(NU - NL)
    return NL, NU, window, logfreq


def _local_peaks_device(frames, threshold_frac):
    """All local spectral maxima per frame above a fraction of the frame max."""
    fm1 = frames[:, :-2]
    f0 = frames[:, 1:-1]
    fp1 = frames[:, 2:]
    is_peak = (f0 > fm1) & (f0 > fp1)
    strong = f0 > threshold_frac * torch.amax(frames, dim=-1, keepdim=True)
    d = fm1 - 2 * f0 + fp1
    denom = torch.where(d == 0, 1e-12, d)
    idx = torch.arange(1, frames.shape[-1] - 1, device=frames.device)[None, :]
    refined = idx + 0.5 * (fm1 - fp1) / denom
    keep = is_peak & strong
    return torch.where(keep, refined, 0.0), torch.where(keep, f0, 0.0)


def trace_partials(spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
                   adaptation_mode="None", threshold=0.15, device="cuda"):
    """Partial tracking diagnostic (wow_detection.py:361-387 uses librosa
    piptrack and only plots).  Returns per-frame (pitches_hz, magnitudes)
    arrays of all local peaks inside the trail band."""
    g = _Grid(spectrum, fft_size, hop, sr, tolerance_st)
    frame_0, frame_1, times, freqs = g.sample_trail(trail)
    fl, fu = float(np.min(freqs)), float(np.max(freqs))
    bl = max(1, int(fl * fft_size / sr))
    bu = min(g.num_bins - 1, int(np.ceil(fu * fft_size / sr)))
    frames = _frames_on_device(spectrum, bl, bu, frame_0, frame_1, device)
    bins, mags = _local_peaks_device(frames, float(np.float32(threshold)))
    pitches = bins.cpu().numpy()
    pitches = np.where(pitches > 0, (pitches + bl) / fft_size * sr, 0.0)
    return times, pitches, mags.cpu().numpy()


def _sine_varpro_seed(tt, yy, w0):
    """Variable-projection seeding: for each candidate omega the model is
    LINEAR in (A sin, A cos, c), so the subproblem solves exactly; the best
    candidate on a log grid around the FFT seed starts LM inside the right
    basin (plain LM from a coarse phase seed can jump basins)."""
    best = None
    for w in np.geomspace(0.5, 2.0, 121) * w0:
        M = np.stack([np.sin(w * tt), np.cos(w * tt), np.ones_like(tt)], axis=1)
        coef, *_ = np.linalg.lstsq(M, yy, rcond=None)
        r = M @ coef - yy
        rss = float(r @ r)
        if best is None or rss < best[0]:
            best = (rss, w, coef)
    _, w, (a, b, c) = best
    A = float(np.hypot(a, b))
    p = float(np.arctan2(b, a))
    return np.array([A, w, p, c])


def _sine_lm(tt, yy, guess, max_iter=100):
    """Levenberg-Marquardt refinement of ``A sin(w t + p) + c`` (float64):
    a variable-projection omega sweep picks the basin, then damped 4x4
    normal equations converge it; covariance follows curve_fit's convention
    ``inv(J'J) * rss/(n-4)``."""
    A, w, p, c = _sine_varpro_seed(tt, yy, float(guess[1]))

    def resid(A, w, p, c):
        return A * np.sin(w * tt + p) + c - yy

    r = resid(A, w, p, c)
    cost = float(r @ r)
    lam = 1e-3
    H = np.eye(4)
    for _ in range(max_iter):
        s = np.sin(w * tt + p)
        co = np.cos(w * tt + p)
        J = np.stack([s, A * tt * co, A * co, np.ones_like(tt)], axis=1)
        g = J.T @ r
        H = J.T @ J
        step_ok = False
        for _ in range(50):
            D = np.diag(np.maximum(np.diag(H), 1e-12))
            try:
                dp = np.linalg.solve(H + lam * D, -g)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            cand = (A + dp[0], w + dp[1], p + dp[2], c + dp[3])
            r2 = resid(*cand)
            cost2 = float(r2 @ r2)
            if cost2 <= cost:
                A, w, p, c = cand
                r, cost = r2, cost2
                lam = max(lam * 0.3, 1e-14)
                step_ok = True
                break
            lam *= 10.0
            if lam > 1e14:
                break
        if not step_ok or np.linalg.norm(dp) < 1e-14 * (1.0 + abs(A) + abs(w)):
            break
    popt = np.array([A, w, p, c])
    dof = max(len(tt) - 4, 1)
    try:
        pcov = np.linalg.inv(H) * cost / dof
    except np.linalg.LinAlgError:
        pcov = np.full((4, 4), np.inf)
    return popt, pcov


def fit_sin(tt, yy, assumed_freq=None):
    """FFT-seeded sine regression (wow_detection.py:190-228), refined by a
    host float64 Levenberg-Marquardt.  Returns a dict with
    amp/omega/phase/offset/freq/period."""
    tt = np.asarray(tt, float)
    yy = np.asarray(yy, float)
    ff = np.fft.rfftfreq(len(tt), (tt[1] - tt[0]))
    fft_data = np.fft.rfft(yy)[1:]
    if assumed_freq:
        period = tt[1] - tt[0]
        N = len(yy) + 1
        peak_est = int(round(assumed_freq * N * period))
        win = np.interp(np.arange(0, len(fft_data)), (0, peak_est, len(fft_data)), (0, 1, 0))
        fft_data = fft_data * win
    peak_bin = np.argmax(np.abs(fft_data)) + 1
    guess_freq = ff[peak_bin]
    guess_amp = np.std(yy) * 2.0 ** 0.5
    guess_offset = np.mean(yy)
    guess_phase = np.angle(fft_data[peak_bin])
    guess = np.array([guess_amp, 2.0 * np.pi * guess_freq, guess_phase, guess_offset])

    popt, pcov = _sine_lm(tt, yy, guess)
    A, w, p, c = popt
    f = w / (2.0 * np.pi)
    return {"amp": A, "omega": w, "phase": p, "offset": c, "freq": f,
            "period": 1.0 / f, "fitfunc": lambda t: A * np.sin(w * t + p) + c,
            "maxcov": np.max(pcov), "rawres": (guess, popt, pcov)}


def trace_sine_reg(speed_curve, t0, t1, rpm=None):
    """Sine regression over a span of the master speed curve
    (wow_detection.py:231-253).  Returns (amplitude, omega, phase, offset)."""
    times = speed_curve[:, 0]
    speeds = speed_curve[:, 1]
    period = times[1] - times[0]
    ind_start = int(t0 / period)
    ind_stop = int(t1 / period)
    try:
        assumed_freq = float(rpm) / 60.0
    except (TypeError, ValueError):
        assumed_freq = None
    res = fit_sin(times[ind_start:ind_stop], speeds[ind_start:ind_stop],
                  assumed_freq=assumed_freq)
    return res["amp"], res["omega"], res["phase"], 0


wow_detectors = {
    "Center of Gravity": trace_cog,
    "Peak": trace_peak,
    "Peak Track": trace_peak_track,
    "Zero-Crossing": trace_zero_crossing,
    "Freehand Draw": trace_freehand,
    "Correlation": trace_correlation,
    # 'Partials' (wow_detection.py:361-387) is a diagnostic that returns
    # per-frame peak stacks rather than one curve: see trace_partials
}


def trace(mode, spectrum, signal, trail, fft_size, hop, sr, tolerance_st=1.0,
          adaptation_mode="None", device="cuda"):
    """Dispatch by tracker name (registry mirror of wow_detection.py:453-456)."""
    return wow_detectors[mode](spectrum, signal, trail, fft_size, hop, sr,
                               tolerance_st, adaptation_mode, device=device)
