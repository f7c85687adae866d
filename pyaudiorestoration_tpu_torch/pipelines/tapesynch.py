"""Sub-sample alignment of two recordings (counterpart of
pyaudiorestoration_tpu/pipelines/tapesynch.py; reference tool:
pytapesynch_gui.py).

Pipeline: lag markers (placed by ``auto_align``, or given) -> windowed
band-passed cross-correlation (``correlate_sources``,
pytapesynch_gui.py:108-133) -> spline lag curve (``models.markers.LagLine``)
-> lag-curve resample of the source (``ops/resampling.run``, whose banded
branch is kernel K1 on the card).

``auto_align`` uploads each signal once; the speed-ratio probe, the window
slicing, the speed resample of all windows (K1, one launch a window), the
band-pass and the delay estimate of all windows stay on the device, and
only the per-window delays and the (F,) mean spectra are downloaded.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..kernels.sinc_banded import KernelError
from ..models import markers as mk
from ..ops import correlation, filters, fourier, resampling
from ..utils import audio_io
from ..utils.device import resolve_device

__all__ = [
    "get_signal", "get_signal_around", "correlate_sources", "improve_lag",
    "azimuth_sweep", "estimate_speed_ratio", "auto_align", "align_files",
    "get_speed_at",
]


def get_signal(signal, sr, t0, t1, channel=0):
    """Zero-padded slice [t0, t1) of one channel (spectrum.py:153-171)."""
    sig = signal[:, channel] if signal.ndim == 2 else signal
    s0 = int(t0 * sr)
    s1 = int(t1 * sr)
    pad_l = max(0, -s0)
    pad_r = max(0, s1 - len(sig))
    piece = sig[max(0, s0):min(len(sig), s1)]
    return np.pad(piece, (pad_l, pad_r))


def get_signal_around(signal, sr, t, width, channel=0):
    return get_signal(signal, sr, t - width, t + width, channel)


def get_speed_at(lag_data, marker_sr, t, width=0.05):
    """Local source-speed estimate from the lag curve's derivative
    (pytapesynch_gui.py:175-192), on the host: the curve is frame-rate sized
    and scipy's float64 filter matches the reference's smoothing."""
    filtered = np.asarray(filters.butter_bandpass_filter(
        lag_data[:, 1], 0, 15, marker_sr, order=3, backend="host"))
    before = np.interp(t - width, lag_data[:, 0], filtered)
    after = np.interp(t + width, lag_data[:, 0], filtered)
    return (after - before) / (2 * width) + 1.0


def correlate_sources(ref_signal, src_signal, sr, t0, t1, delay, lower, upper,
                      ignore_phase=False, window_name=None, speed=1.0, device="cuda"):
    """Windowed band-passed delay estimate between the two sources
    (pytapesynch_gui.py:108-133).  ``speed`` != 1 resamples the source
    window to the reference's speed first, so the delay is measured in the
    reference's time and is divided by ``speed`` into the source's (the
    JAX package multiplies, see ``auto_align``).  Returns
    (time_delay_seconds, correlation)."""
    t_center = (t0 + t1) / 2
    t_width = (t1 - t0) / 2
    ref_sig = get_signal_around(ref_signal, sr, t_center, t_width)
    if speed != 1.0:
        src_sig = get_signal_around(src_signal, sr, t_center - delay, t_width / speed)
        src_sig = resampling.resample_ratio(src_sig, sr / speed, sr, quality=8,
                                            device=device)
    else:
        src_sig = get_signal_around(src_signal, sr, t_center - delay, t_width)
    n = min(len(ref_sig), len(src_sig))
    a = filters.butter_bandpass_filter(ref_sig[:n], lower, upper, sr, order=3,
                                       device=device)
    b = filters.butter_bandpass_filter(src_sig[:n], lower, upper, sr, order=3,
                                       device=device)
    sample_delay, corr = correlation.find_delay(a, b, ignore_phase=ignore_phase,
                                                window_name=window_name, device=device)
    return float(sample_delay) / sr / speed, float(corr)


def improve_lag(ref_signal, src_signal, sr, lag_samples, lower=None, upper=None,
                ignore_phase=False, match_speed=False, lag_data=None, marker_sr=None,
                device="cuda"):
    """Refine lag markers in place (pytapesynch_gui.py:92-106); a marker whose
    window cannot be correlated is logged and left as it was."""
    for lag in lag_samples:
        try:
            t0, t1 = sorted((lag.a[0], lag.b[0]))
            lo = lower if lower is not None else min(lag.a[1], lag.b[1])
            hi = upper if upper is not None else max(lag.a[1], lag.b[1])
            speed = 1.0
            if match_speed and lag_data is not None:
                speed = get_speed_at(lag_data, marker_sr, (t0 + t1) / 2)
            time_delay, corr = correlate_sources(
                ref_signal, src_signal, sr, t0, t1, lag.d, lo, hi,
                ignore_phase=ignore_phase, speed=speed, device=device)
            lag.d += time_delay
            lag.corr = corr
        except Exception as e:
            if _device_fault(e):
                raise
            logging.exception("Refining failed")
    return lag_samples


def azimuth_sweep(ref_signal, src_signal, sr, t0, t1, lower, upper, lag_data,
                  dur=0.1, overlap=4, reject=0.3, ignore_phase=False, device="cuda"):
    """Per-window delay sweep across [t0, t1] -> AzimuthLine
    (pytapesynch_gui.py:211-238), every window correlated in one batched
    call on the device."""
    sample_times = np.arange(t0, t1, dur / overlap)
    if not len(sample_times):
        return None
    sample_lags = np.interp(sample_times, lag_data[:, 0], lag_data[:, 1])
    n_win = int(round(2 * dur * sr))
    refs = np.stack([get_signal_around(ref_signal, sr, x, dur)[:n_win]
                     for x in sample_times])
    srcs = np.stack([get_signal_around(src_signal, sr, x - d, dur)[:n_win]
                     for x, d in zip(sample_times, sample_lags)])
    refs = _dsp_bandpass_rows(refs, lower, upper, sr, materialize=False, device=device)
    srcs = _dsp_bandpass_rows(srcs, lower, upper, sr, materialize=False, device=device)
    delays, corrs = correlation.find_delay_batch(refs, srcs, ignore_phase=ignore_phase,
                                                 window_name="hann", device=device)
    lags = sample_lags + delays.cpu().numpy() / sr
    marker = mk.AzimuthLine(sample_times, lags, corrs.cpu().numpy(), lower, upper)
    marker.update_reject(overlap, reject)
    return marker


def estimate_speed_ratio(ref_signal, src_signal, sr, fft_size=16384, f_lo=50.0,
                         f_hi=None, device="cuda"):
    """Global speed ratio of src relative to ref from the log2-frequency shift
    of their average spectra (the Correlation tracker's trick across files,
    wow_detection.py:396-436 applied globally).  The frame mean runs on the
    device; only the (F,) mean spectra are downloaded."""
    f_hi = f_hi or sr / 2 * 0.9
    hop = fft_size // 2

    def mean_logspec(sig):
        mono = sig[:, 0] if sig.ndim == 2 else sig
        return fourier.get_mag(mono, fft_size, hop, "hann", device=device).mean(dim=1)

    a_dev = mean_logspec(ref_signal)
    a, b = a_dev.cpu().numpy(), mean_logspec(src_signal).cpu().numpy()
    freqs = fourier.fft_freqs(fft_size, sr)
    lo, hi = np.searchsorted(freqs, (f_lo, f_hi))
    log_grid = np.linspace(np.log2(freqs[lo]), np.log2(freqs[hi - 1]), 4 * (hi - lo))
    la = np.interp(log_grid, np.log2(freqs[lo:hi]), np.log(a[lo:hi] + 1e-10))
    lb = np.interp(log_grid, np.log2(freqs[lo:hi]), np.log(b[lo:hi] + 1e-10))
    la -= la.mean()
    lb -= lb.mean()
    dev = a_dev.device
    res = correlation.xcorr(torch.as_tensor(la * np.hanning(len(la)), device=dev),
                            torch.as_tensor(lb * np.hanning(len(lb)), device=dev),
                            mode="same").cpu()
    i_peak = int(torch.argmax(res))
    i_interp, _ = correlation.parabolic(res, min(max(i_peak, 1), len(res) - 2))
    shift_log2 = ((float(i_interp) - len(res) // 2) * (log_grid[-1] - log_grid[0])
                  / len(log_grid))
    # src content shifted up by s octaves lags the ref spectrum on the log
    # grid, putting the correlation peak at center - s: ratio = 2**(-shift)
    return float(2.0 ** (-shift_log2))


def _fixed_window(signal, sr, t_start, length, channel=0):
    """Zero-padded fixed-length slice starting at ``t_start`` seconds."""
    sig = signal[:, channel] if signal.ndim == 2 else signal
    s0 = int(round(t_start * sr))
    s1 = s0 + length
    pad_l = max(0, -s0)
    pad_r = max(0, s1 - len(sig))
    piece = sig[max(0, s0):min(len(sig), s1)]
    return np.pad(piece, (pad_l, pad_r))


def _fixed_windows_device(sig_dev, sr, starts_s, length):
    """Batched :func:`_fixed_window` sliced on the device from an uploaded
    mono signal: the host sends the B start indices, not the windows (the
    same ``int(round(t*sr))`` indices, zeros outside the signal)."""
    n = sig_dev.shape[0]
    s0 = torch.as_tensor([int(round(t * sr)) for t in starts_s], dtype=torch.int64,
                         device=sig_dev.device)
    idx = s0[:, None] + torch.arange(length, device=sig_dev.device)[None, :]
    mask = (idx >= 0) & (idx < n)
    return torch.where(mask, sig_dev[torch.clamp(idx, 0, n - 1)], 0.0)


# faults of the card or of a kernel (a kernel that failed to build, load,
# launch or take its arguments), which no per-window fallback may hide
_DEVICE_FAULTS = (KernelError, torch.cuda.OutOfMemoryError, torch.cuda.CudaError,
                  *((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError")
                    else ()))


def _device_fault(e) -> bool:
    """True for a fault of the card or of a kernel, False for one of the data."""
    return isinstance(e, _DEVICE_FAULTS) or (isinstance(e, RuntimeError)
                                              and "CUDA" in str(e))


def auto_align(ref_signal, src_signal, sr, num_windows=8, window_s=1.0, lower=100.0,
               upper=None, hop=64, smoothing=3, match_speed=True, device="cuda"):
    """Headless alignment: estimate the global speed ratio, then correlate
    ``num_windows`` windows along the overlap to build the lag curve.

    All window pairs go through one speed resample, one batched band-pass
    and one ``find_delay_batch`` call.  If that batched path fails on the
    data, each window is correlated on its own and a failing window is
    skipped (the reference's rule: one bad window must not stop the run,
    tapesynch.py:246-261); a fault of the card or of a kernel is raised.

    The windows of the source are resampled by the speed ratio r onto the
    reference's time, so a delay measured between them is in the
    reference's seconds and the lag, in the source's, takes it divided by
    r.  The JAX package multiplies by r (tapesynch.py:240): with a source
    both r fast and late by D its lags are off by D (r - 1/r), 5.9 ms for
    5 % and 60 ms, where the port's are not.

    Returns (lag_samples, lag_curve_data), the curve (n, 2) time/lag seconds
    on the reference's timeline."""
    dev = resolve_device(device)
    upper = upper or sr / 4
    ref_dev = torch.as_tensor(np.ascontiguousarray(
        ref_signal[:, 0] if ref_signal.ndim == 2 else ref_signal), dtype=torch.float32,
        device=dev)
    src_dev = torch.as_tensor(np.ascontiguousarray(
        src_signal[:, 0] if src_signal.ndim == 2 else src_signal), dtype=torch.float32,
        device=dev)
    ratio = estimate_speed_ratio(ref_dev, src_dev, sr) if match_speed else 1.0
    logging.info(f"Source speed ratio estimate: {ratio:.5f}")
    dur_ref = len(ref_signal) / sr
    centers = np.linspace(window_s, dur_ref - window_s, num_windows)
    # src ~ ref resampled by ratio: the source position of ref time t is
    # t/ratio, so lag(t) = t - t/ratio
    lag_guess = centers - centers / ratio
    try:
        L = int(round(2 * window_s * sr))
        refs = _fixed_windows_device(ref_dev, sr, [t - window_s for t in centers], L)
        if ratio != 1.0:
            Ls = int(round(2 * window_s / ratio * sr))
            srcs = _fixed_windows_device(
                src_dev, sr, [t - d0 - window_s / ratio
                              for t, d0 in zip(centers, lag_guess)], Ls)
            srcs = resampling.resample_ratio(srcs.T, sr / ratio, sr, quality=8,
                                             device_out=True).T
        else:
            srcs = _fixed_windows_device(
                src_dev, sr, [t - d0 - window_s for t, d0 in zip(centers, lag_guess)], L)
        n = min(refs.shape[1], srcs.shape[1])
        a = _dsp_bandpass_rows(refs[:, :n], lower, upper, sr, materialize=False)
        b = _dsp_bandpass_rows(srcs[:, :n], lower, upper, sr, materialize=False)
        delays, corrs = correlation.find_delay_batch(a, b, window_name="hann")
        time_delays = delays.cpu().numpy() / sr / ratio
        corrs = corrs.cpu().numpy()
        samples = [mk.LagSample((t - window_s, lower), (t + window_s, upper),
                                d0 + float(td), float(c))
                   for t, d0, td, c in zip(centers, lag_guess, time_delays, corrs)]
    except Exception as e:
        if _device_fault(e):
            raise
        logging.exception("batched auto_align failed; falling back per window")
        samples = []
        for t, d0 in zip(centers, lag_guess):
            try:
                delay, corr = correlate_sources(
                    ref_signal, src_signal, sr, t - window_s, t + window_s, d0,
                    lower, upper, window_name="hann", speed=ratio, device=dev)
                samples.append(mk.LagSample((t - window_s, lower), (t + window_s, upper),
                                            d0 + delay, corr))
            except Exception as e2:
                if _device_fault(e2):
                    raise
                logging.exception(f"auto_align window at {t:.2f}s failed")
    lag_line = mk.LagLine(sr, hop, dur_ref, smoothing=smoothing)
    return samples, lag_line.update(samples)


def _dsp_bandpass_rows(rows, lower, upper, sr, materialize=True, device="cuda"):
    """Band-pass a (batch, n) stack along its last axis in one call (the
    float64 scan); ``materialize=False`` keeps the result on the device."""
    out = filters.butter_bandpass_filter(rows, lower, upper, sr, order=3, device=device)
    if not materialize:
        return out
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def align_files(ref_path, src_path, out_suffix="", num_windows=8, window_s=1.0,
                lower=100.0, upper=None, smoothing=3, use_channels=(),
                resampling_mode="Sinc", sinc_quality=50, save_project=False,
                device="cuda"):
    """BASELINE config 4: align ``src`` to ``ref`` and write the resampled
    source ``<src>_res<suffix>`` (pytapesynch_gui.py:145-155).  Returns
    (output paths, lag samples, lag curve)."""
    resolve_device(device)
    ref_signal, sr, _ = audio_io.read_file(ref_path)
    src_signal, sr2, _ = audio_io.read_file(src_path)
    if sr2 != sr:
        src_signal = resampling.resample_ratio(src_signal, sr2, sr, device=device)
    samples, lag_curve = auto_align(ref_signal, src_signal, sr, num_windows=num_windows,
                                    window_s=window_s, lower=lower, upper=upper,
                                    smoothing=smoothing, device=device)
    if save_project:
        from ..utils import project

        proj = project.Project(".tapesync", {
            "reference": ref_path, "source": src_path, "smoothing": smoothing,
            "resampling_mode": resampling_mode, "sinc_quality": sinc_quality,
            "suffix": out_suffix,
        }, {"lags": samples, "azimuths": []})
        proj.save(project.project_path_for(src_path, ".tapesync"))
    paths = resampling.run(
        (src_path,), signal_data=((src_signal, sr),), lag_curve=lag_curve,
        resampling_mode=resampling_mode, sinc_quality=sinc_quality,
        use_channels=use_channels, suffix=out_suffix, device=device)
    return paths, samples, lag_curve
