"""Dropout detection and healing, and the batch dropout repair (counterpart
of pyaudiorestoration_tpu/pipelines/dropouts.py).

Reference tools: dropout_healer_gui.py (marked or detected dropout boxes,
spectral-gain inpainting) and dropouts_gui.py (batch heuristic repair over
log-spaced bands, and the max/min mono folds).

Heal: the STFT, the dB gain mask of every box and the iSTFT of all channels
stay on the device in one call.  The heuristic repair measures band volumes
on the device, picks its valleys on the host (scipy, as the reference), and
runs the band cascade on the device in float64: the gain curve is
interpolated as ``np.interp`` does and band-passed by the float64
``sosfiltfilt``.  The JAX package rebuilds that float64 interpolation from
float32 pairs because the TPU has none (``_upsample_linear_exact``); the
card has float64, so that code is not ported.
"""

from __future__ import annotations

import itertools
import logging
import os
import time

import numpy as np
import scipy.signal
import torch

from ..models import markers as mk
from ..ops import filters, fourier, units
from ..utils import audio_io, streaming
from ..utils.device import resolve_device

__all__ = ["detect_dropouts", "heal", "heal_file", "process_heuristic",
           "process_heuristic_streamed", "process_max_mono"]


def _time_2_frame(t, sr, hop):
    return int(t * sr / hop)


def _frame_2_time(f, sr, hop):
    return f / sr * hop


def _freq_2_bin(f, fft_size, sr):
    return max(1, min(fft_size // 2, int(round(f * fft_size / sr))))


def detect_dropouts(spectrum_db, sr, hop, fft_size, t0, t1, f_lower, f_upper,
                    width_ms=20.0, sensitivity=5.0, surrounding=0.5):
    """Auto-detect dropouts inside a time-frequency region
    (dropout_healer_gui.py:184-242), on the host.

    ``spectrum_db``: (bins, frames) dB magnitude.  Returns DropoutSample list.
    """
    frame_b = _time_2_frame(t0, sr, hop)
    frame_a = _time_2_frame(t1, sr, hop)
    bin_l = _freq_2_bin(f_lower, fft_size, sr)
    bin_u = _freq_2_bin(f_upper, fft_size, sr)
    vol = np.mean(spectrum_db[bin_l:bin_u, frame_b:frame_a], axis=0)
    base_half_width = width_ms / 1000 / 2
    frames_half_width = _time_2_frame(base_half_width, sr, hop)
    savgol_win = min(max(frames_half_width * 12, 7), max(len(vol) - 1, 2))
    vol_lt = scipy.signal.savgol_filter(vol, savgol_win, min(5, savgol_win - 1))
    st_win = min(max(frames_half_width, 7), max(len(vol) - 1, 2))
    vol_st = scipy.signal.savgol_filter(vol, st_win, min(5, st_win - 1))
    peaks, _ = scipy.signal.find_peaks(-vol, prominence=10.0 - sensitivity, rel_height=0.5)
    out = []
    for f_peak in peaks:
        half_width = base_half_width
        t_center = _frame_2_time(frame_b + f_peak, sr, hop)
        try:
            # refine width: parabola through the dropout vs the long-term curve
            f_qw = _time_2_frame(half_width / 4, sr, hop)
            xp = np.arange(f_peak - f_qw, f_peak + f_qw)
            coeff = np.polyfit(xp, vol_st[f_peak - f_qw:f_peak + f_qw], 2)
            parabola = np.poly1d(coeff)
            f_hw = _time_2_frame(half_width, sr, hop)
            xp = np.arange(f_peak - f_hw, f_peak + f_hw)
            fp = parabola(xp)
            f_int = scipy.signal.argrelmin(np.abs(fp - vol_lt[f_peak - f_hw:f_peak + f_hw]))[0]
            if len(f_int) != 2:
                raise ValueError(f"{len(f_int)} crossings")
            half_width = _frame_2_time(f_int[1] - f_int[0], sr, hop)
        except (ValueError, TypeError, np.linalg.LinAlgError):
            logging.debug(f"Could not refine width at peak {f_peak}")
        out.append(mk.DropoutSample((t_center - half_width, f_lower),
                                    (t_center + half_width, f_upper), surrounding))
    return out


def _box_params(drop, sr, hop, fft_size):
    """(frame_b, frame_a, surr, bin_l, bin_u) of one DropoutSample
    (dropout_healer_gui.py:136-143 conversions)."""
    frame_b = _time_2_frame(drop.t - drop.width / 2, sr, hop)
    frame_a = _time_2_frame(drop.t + drop.width / 2, sr, hop)
    surr = max(1, _time_2_frame(drop.width * drop.surrounding, sr, hop))
    bin_l = _freq_2_bin(drop.f - drop.height / 2, fft_size, sr)
    bin_u = _freq_2_bin(drop.f + drop.height / 2, fft_size, sr)
    return frame_b, frame_a, surr, bin_l, bin_u


def _boxes_array(dropouts, sr, hop, fft_size, pad_to=8):
    """Host: DropoutSample list -> (K, 6) int32 rows [frame_b, frame_a,
    surr, bin_l, bin_u, valid], padded with invalid rows to a multiple of
    ``pad_to`` as in JAX (dropouts.py:165-176)."""
    rows = []
    for drop in dropouts:
        fb, fa, surr, bl, bu = _box_params(drop, sr, hop, fft_size)
        rows.append([fb, fa, surr, bl, bu, int(fa > fb and bu > bl)])
    K = max(pad_to, -(-len(rows) // pad_to) * pad_to) if rows else pad_to
    rows += [[0, 0, 1, 0, 0, 0]] * (K - len(rows))
    return np.asarray(rows, np.int32)


def _heal_spectrum(spec, boxes):
    """The healed spectrum of ``spec`` (C, F, T): the dB gain mask of every
    valid box of ``boxes`` (:func:`_boxes_array`) at frame rate, applied.

    The reference's sequential clip accumulation (dropout_healer_gui.py:
    155-158; JAX's ``lax.scan`` over boxes) is a running maximum capped at
    255 dB, so the boxes are applied one after another to their own slices
    of the mask: bins [bin_l, bin_u) x frames [frame_b, frame_a), the gain
    lerping in dB from the mean spectrum of the ``surr`` frames before to
    that of the ``surr`` frames after."""
    spec_db = 20.0 * torch.log10(torch.abs(spec) + 1e-7)
    T = spec_db.shape[-1]
    gain = torch.zeros_like(spec_db)
    for fb, fa, surr, bl, bu, valid in np.asarray(boxes).tolist():
        f0, f1 = max(fb, 0), min(fa, T)
        if not valid or f1 <= f0:
            continue
        before = spec_db[:, bl:bu, max(0, fb - surr):max(0, min(fb, T))]
        after = spec_db[:, bl:bu, min(fa, T):min(T, max(0, fa + surr))]
        mag_before = before.sum(-1) / max(before.shape[-1], 1)
        mag_after = after.sum(-1) / max(after.shape[-1], 1)
        # np.linspace(0, 1, fa-fb): w_k = k / (fa - fb - 1)
        w = (torch.arange(f0, f1, device=spec.device) - fb).to(torch.float32) \
            / max(fa - fb - 1, 1)
        fp_db = mag_before[..., None] * (1 - w) + mag_after[..., None] * w
        g = gain[:, bl:bu, f0:f1]
        gain[:, bl:bu, f0:f1] = torch.clamp(
            torch.maximum(fp_db - spec_db[:, bl:bu, f0:f1], g), max=255.0)
    return spec * torch.pow(10.0, gain / 20.0)


def _heal_fused(x_pad, boxes, fft_size: int, hop: int, n: int):
    """Heal all channels of ``x_pad`` (C, n + pad) on its device in one
    call (dropouts.py:127-162): STFT, :func:`_heal_spectrum`, iSTFT to
    (C, n)."""
    spec = fourier.stft(x_pad, n_fft=fft_size, step=hop)  # (C, F, T)
    return fourier.istft(_heal_spectrum(spec, boxes), length=n, hop_length=hop)


def heal(signal, sr, dropouts, fft_size=512, fft_overlap=16, channels=None,
         device="cuda"):
    """Spectral-gain inpainting of dropout boxes (dropout_healer_gui.py:111-166):
    every selected channel in one device call (:func:`_heal_fused`).
    ``signal`` (n, channels) host float32.  Returns the healed selected
    channels, (n, len(channels))."""
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    channels = list(channels) if channels else list(range(signal.shape[1]))
    n = len(signal)
    y_pad = fourier.fix_length(signal, n + fft_size // 2, axis=0)
    boxes = _boxes_array(dropouts, sr, hop, fft_size)
    x = torch.as_tensor(np.ascontiguousarray(y_pad[:, channels].T), device=dev)
    out = _heal_fused(x, boxes, fft_size, hop, n)
    return out.cpu().numpy().T.astype(signal.dtype)


def heal_file(file_path, dropouts, fft_size=512, fft_overlap=16, channels=None,
              suffix="", stream="auto", stream_threshold_bytes: int = 1 << 30,
              device="cuda"):
    """Heal a file and write ``<name>_drops<suffix>.<ext>``.

    ``stream``: True forces the blockwise larger-than-memory path; "auto"
    streams when the decoded size exceeds ``stream_threshold_bytes``."""
    resolve_device(device)
    if streaming.should_stream(file_path, stream, stream_threshold_bytes):
        return _heal_file_streamed(file_path, dropouts, fft_size, fft_overlap,
                                   channels, suffix, device)
    signal, sr, num_channels = audio_io.read_file(file_path)
    channels = list(channels) if channels else list(range(num_channels))
    output = heal(signal, sr, dropouts, fft_size, fft_overlap, channels, device)
    return audio_io.write_file(file_path, output, sr, len(channels),
                               suffix=f"_drops{suffix}")


def _heal_file_streamed(file_path, dropouts, fft_size, fft_overlap, channels,
                        suffix, device="cuda"):
    """Streamed heal (dropouts.py:215-281).  Stage 1 computes each box's dB
    gain patch from a local frame span read at one span shape for all boxes
    (the same frames as the in-memory STFT, so the same patches); stage 2
    streams the masked STFT round trip, max-merging the patches into each
    block's mask on the device (the capped running max is order-free)."""
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    pad = fft_size // 2
    with audio_io.StreamReader(file_path) as r:
        sr = r.sample_rate
        n = int(r.frames)
        chans = list(channels) if channels else list(range(r.channels))
        T = (n + pad) // hop + 1
        boxes = [bp for bp in (_box_params(d, sr, hop, fft_size) for d in dropouts)
                 if bp[1] > bp[0] and bp[4] > bp[3]]
        spans = [(max(0, fb - surr), min(T, fa + surr)) for fb, fa, surr, _, _ in boxes]
        # one span size for every box: the 64-frame-rounded largest span
        t_span = max((hi - lo for lo, hi in spans), default=64)
        t_span = -(-t_span // 64) * 64
        patches = []
        for (fb, fa, surr, bl, bu), (t_lo, t_hi) in zip(boxes, spans):
            a = t_lo * hop - pad
            b = (t_lo + t_span - 1) * hop - pad + fft_size
            span = torch.as_tensor(streaming.virtual_read(r, a, b, pad, chans).T,
                                   device=dev)
            spec = fourier.stft(span, n_fft=fft_size, step=hop, center=False)
            # only the real magnitude is downloaded
            mag = torch.abs(spec[..., :t_hi - t_lo]).cpu().numpy()
            spec_db = 20.0 * np.log10(mag + np.float32(1e-7))
            before = spec_db[:, bl:bu, max(0, fb - surr) - t_lo:fb - t_lo]
            after = spec_db[:, bl:bu, fa - t_lo:min(T, fa + surr) - t_lo]
            zero = np.zeros_like(spec_db[:, bl:bu, 0])
            mag_before = before.mean(-1) if before.shape[-1] else zero
            mag_after = after.mean(-1) if after.shape[-1] else zero
            w = np.linspace(0.0, 1.0, num=fa - fb)[None, None, :]
            fp_db = mag_before[..., None] * (1 - w) + mag_after[..., None] * w
            patch = np.clip(fp_db - spec_db[:, bl:bu, fb - t_lo:fa - t_lo], 0.0, 255.0)
            patches.append((fb, fa, bl, bu,
                            torch.as_tensor(patch.astype(np.float32), device=dev)))

    def make_fac(spec_blk, t_lo):
        gain = torch.zeros(spec_blk.shape, dtype=torch.float32, device=spec_blk.device)
        Tb = spec_blk.shape[-1]
        for fb, fa, bl, bu, patch in patches:
            s0, s1 = max(fb, t_lo), min(fa, t_lo + Tb)
            if s1 > s0:
                sl = gain[:, bl:bu, s0 - t_lo:s1 - t_lo]
                gain[:, bl:bu, s0 - t_lo:s1 - t_lo] = torch.maximum(
                    sl, patch[:, :, s0 - fb:s1 - fb])
        return torch.pow(10.0, gain / 20.0)

    base, _ = os.path.splitext(file_path)
    out_path = f"{base}_drops{suffix}.{audio_io.out_ext()}"
    return streaming.stream_masked_stft(file_path, out_path, make_fac, fft_size, hop,
                                        chans, device=dev)


def _pairwise(iterable):
    a, b = itertools.tee(iterable)
    next(b, None)
    return zip(a, b)


def _band_pairs(f_lower, f_upper, num_bands):
    """Log-spaced band edges, highest band first (dropouts_gui.py:253).
    Python ints, not the reference's uint16: under NumPy 2's promotion
    ``uint16_band * fft_size`` wraps mod 65536 and corrupts every bin edge."""
    bands = [int(b) for b in np.logspace(np.log2(f_lower), np.log2(f_upper),
                                         num=num_bands, endpoint=True, base=2)]
    return list(reversed(list(_pairwise(bands))))


def _band_vols_device(mag, band_pairs, fft_size, sr):
    """(bands, C, T) float64 host array of per-band mean-dB volume curves
    from a (C, bins, T) magnitude tensor: the dB and the band means on the
    device, only the curves downloaded.  NaN rows mark bands narrower than
    one bin (the reference lets np.mean of the empty slice poison the
    file, dropouts_gui.py:283; they are skipped downstream)."""
    db = units.to_dB(mag)
    C, _, T = db.shape
    vols = np.full((len(band_pairs), C, T), np.nan)
    rows, idx = [], []
    for b, (f_lower_band, f_upper_band) in enumerate(band_pairs):
        bin_lower = int(f_lower_band * fft_size / sr)
        bin_upper = int(f_upper_band * fft_size / sr)
        if bin_upper > bin_lower:
            rows.append(db[:, bin_lower:bin_upper].mean(dim=1))
            idx.append(b)
    if rows:
        vols[idx] = torch.stack(rows).cpu().numpy()
    return vols


def _heuristic_fac(vols, d, max_slope, bottom_freedom):
    """Valley peaks + slope gate + sequential bottom_freedom clip chain
    (dropouts_gui.py:262-307) over the band volume curves, on the host.
    ``vols``: (bands, C, T).  Returns (C, bands, T) gain factors."""
    n_bands, C, T = vols.shape
    fac_all = np.empty((C, n_bands, T))
    for channel in range(C):
        correction_fac = np.ones(T) * 1000
        for b in range(n_bands):
            vol = vols[b, channel]
            gain_curve = np.zeros(T)
            if not np.isnan(vol[0]):
                peaks, _ = scipy.signal.find_peaks(-vol, prominence=5, rel_height=0.5)
                for peak_i in peaks:
                    if 2 * d < peak_i < T - 2 * d - 1:
                        left = np.mean(vol[peak_i - 2 * d:peak_i - d])
                        right = np.mean(vol[peak_i + d:peak_i + 2 * d])
                        m = (left - right) / (2 * d)
                        if abs(m) < max_slope:
                            gain_curve[peak_i - d:peak_i + d + 1] = np.interp(
                                range(2 * d + 1), (0, 2 * d), (left, right)
                            ) - vol[peak_i - d:peak_i + d + 1]
            correction_fac = np.clip(units.to_fac(gain_curve), 1,
                                     correction_fac * bottom_freedom)
            fac_all[channel, b] = correction_fac
    return fac_all


def _interp_rows(rows, lo: int, hi: int, n: int):
    """``np.interp(np.linspace(0, 1, n)[lo:hi], np.linspace(0, 1, T), row)``
    for every row of the (C, T) float64 tensor ``rows``, in float64 on its
    device, with numpy's positions, segment choice and formula."""
    dev = rows.device
    T = rows.shape[-1]
    x = torch.arange(lo, hi, dtype=torch.float64, device=dev) * (1.0 / (n - 1))
    if hi == n:
        x[-1] = 1.0  # np.linspace sets its last point to stop exactly
    xp = torch.arange(T, dtype=torch.float64, device=dev) * (1.0 / (T - 1))
    xp[-1] = 1.0
    j = torch.clamp(torch.searchsorted(xp, x, right=True) - 1, 0, T - 2)
    slopes = (rows[:, 1:] - rows[:, :-1]) / (xp[1:] - xp[:-1])
    out = slopes[:, j] * (x - xp[j]) + rows[:, j]
    # numpy returns the sample itself at a knot and past the last one
    return torch.where(x == xp[j], rows[:, j], torch.where(x >= 1.0, rows[:, -1:], out))


def _band_cascade(sig, fac_dev, band_pairs, sr, lo: int, hi: int, n: int):
    """Every band's envelope multiply, zero-phase band-pass and accumulate
    (dropouts_gui.py:308-316) on the (C, hi - lo) float32 tensor ``sig``,
    samples [lo, hi) of an n-sample signal: the gain curve interpolated in
    float64, the product in float64 into the float64 ``sosfiltfilt``, the
    sum in float32 (as JAX's host backend)."""
    for b, (f_lower_band, f_upper_band) in enumerate(band_pairs):
        w = _interp_rows(fac_dev[:, b], lo, hi, n)
        sig = sig + filters.butter_bandpass_filter(
            sig.to(torch.float64) * w, f_lower_band, f_upper_band, sr, order=3)
    return sig


def process_heuristic(file_path, fft_size=1024, fft_overlap=4, max_width=0.02,
                      max_slope=0.5, num_bands=12, bottom_freedom=2.0,
                      f_lower=3000.0, f_upper=12000.0, suffix="", stream="auto",
                      stream_threshold_bytes: int = 1 << 30, device="cuda",
                      timings=None):
    """Batch heuristic dropout repair over log-spaced bands
    (dropouts_gui.py:241-323): per band, find volume valleys, gate on slope,
    patch the band-passed gain difference back in.  The cascade is JAX's
    ``filter_backend="host"`` arithmetic (float64 interpolation and filter)
    on the device.  ``stream``: True forces the two-pass blockwise path
    (:func:`process_heuristic_streamed`); "auto" streams past
    ``stream_threshold_bytes`` decoded.  ``timings``, a dict, receives the
    in-memory path's seconds: read, spectrum (upload, STFT, band volumes),
    the host valley picking, the cascade (with its download) and write."""
    dev = resolve_device(device)
    if streaming.should_stream(file_path, stream, stream_threshold_bytes):
        return process_heuristic_streamed(
            file_path, fft_size, fft_overlap, max_width, max_slope, num_bands,
            bottom_freedom, f_lower, f_upper, suffix, device=dev)
    hop = fft_size // fft_overlap
    t_read = time.perf_counter()
    signal, sr, num_channels = audio_io.read_file(file_path)
    band_pairs = _band_pairs(f_lower, f_upper, num_bands)
    d = int(max_width / 1.5 * sr / hop)
    n = len(signal)
    t0 = time.perf_counter()
    sig = torch.as_tensor(np.ascontiguousarray(signal.T), device=dev)  # (C, n)
    mag = fourier.get_mag(sig, fft_size, hop, "hann")  # (C, bins, T)
    vols = _band_vols_device(mag, band_pairs, fft_size, sr)
    del mag
    t1 = time.perf_counter()
    fac_all = _heuristic_fac(vols, d, max_slope, bottom_freedom)
    t2 = time.perf_counter()
    fac_dev = torch.as_tensor(fac_all - 1.0, device=dev)
    out = _band_cascade(sig, fac_dev, band_pairs, sr, 0, n, n).cpu().numpy().T
    t3 = time.perf_counter()
    path = audio_io.write_file(file_path, out, sr, num_channels, suffix=suffix or "_out")
    if timings is not None:
        timings.update(read_s=t0 - t_read, spectrum_s=t1 - t0, heuristic_fac_s=t2 - t1,
                       cascade_s=t3 - t2, write_s=time.perf_counter() - t3)
    return path


def process_heuristic_streamed(file_path, fft_size=1024, fft_overlap=4,
                               max_width=0.02, max_slope=0.5, num_bands=12,
                               bottom_freedom=2.0, f_lower=3000.0,
                               f_upper=12000.0, suffix="",
                               block_frames: int = 16384,
                               halo_seconds: float = 0.5, device="cuda"):
    """Larger-than-memory heuristic repair in two streamed passes
    (dropouts.py:334-411).  Pass 1 collects the band volume curves by
    blocks of frames on the exact global frame grid, so every valley
    decision matches the in-memory path; the only whole-recording state is
    the (bands, C, T) curves.  Pass 2 re-reads sample blocks with an IIR
    halo, runs the band cascade on the device, trims the halo and writes
    through ``open_writer``.  The interior differs from the in-memory file
    only by the halo's truncation of the zero-phase filters."""
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    band_pairs = _band_pairs(f_lower, f_upper, num_bands)
    with audio_io.StreamReader(file_path) as r:
        sr = r.sample_rate
        n = int(r.frames)
        C = r.channels
        chans = list(range(C))
        d = int(max_width / 1.5 * sr / hop)
        pad = fft_size // 2
        T = (n + 2 * pad - fft_size) // hop + 1
        vols = np.full((len(band_pairs), C, T), np.nan)
        # pass 1: the band volumes, frame-exact, by blocks of frames
        for t0 in range(0, T, block_frames):
            t1 = min(T, t0 + block_frames)
            a = t0 * hop - pad
            b = (t1 - 1) * hop - pad + fft_size
            span = torch.as_tensor(streaming.virtual_read(r, a, b, 0, chans).T,
                                   device=dev)
            mag = fourier.get_mag(span, fft_size, hop, "hann", center=False)
            vols[:, :, t0:t1] = _band_vols_device(mag, band_pairs, fft_size, sr)
        fac_dev = torch.as_tensor(_heuristic_fac(vols, d, max_slope, bottom_freedom)
                                  - 1.0, device=dev)

        # pass 2: the band cascade by blocks with an IIR halo
        halo = int(halo_seconds * sr)
        base, _ = os.path.splitext(file_path)
        out_path = f"{base}{suffix or '_out'}.{audio_io.out_ext()}"
        blk = block_frames * hop
        with audio_io.open_writer(out_path, sr, C) as w:
            for s0 in range(0, n, blk):
                s1 = min(n, s0 + blk)
                lo = max(0, s0 - halo)
                hi = min(n, s1 + halo)
                sig = torch.as_tensor(np.ascontiguousarray(r.read(lo, hi - lo).T),
                                      device=dev)
                sig = _band_cascade(sig, fac_dev, band_pairs, sr, lo, hi, n)
                w.write(sig[:, s0 - lo:s1 - lo].T.cpu().numpy())
    logging.info(f"Wrote {out_path}")
    return out_path


def process_max_mono(file_path, fft_size=1024, fft_overlap=4, suffix="",
                     stream="auto", stream_threshold_bytes: int = 1 << 30,
                     device="cuda"):
    """Stereo -> mono folds keeping the per-bin louder (and quieter) channel
    (dropouts_gui.py:137-163).  Returns the two output paths.  ``stream``:
    True forces the blockwise path (one pass, both folds through the
    streaming engine's channel mix-down); "auto" streams past the decoded
    threshold."""
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    if streaming.should_stream(file_path, stream, stream_threshold_bytes):
        def make_fac(spec, t_lo):
            # per-bin channel choice as 0/1 masks; mix_down sums L*m + R*(1-m)
            mask_max = (torch.abs(spec[0]) > torch.abs(spec[1])).to(torch.float32)
            mask_min = (torch.abs(spec[0]) < torch.abs(spec[1])).to(torch.float32)
            return [torch.stack([mask_max, 1.0 - mask_max]),
                    torch.stack([mask_min, 1.0 - mask_min])]

        base, _ = os.path.splitext(file_path)
        ext = audio_io.out_ext()
        outs = [f"{base}max{suffix}.{ext}", f"{base}min{suffix}.{ext}"]
        with audio_io.StreamReader(file_path) as r:
            if r.channels != 2:
                raise ValueError("expects stereo input")
        return streaming.stream_masked_stft(file_path, outs, make_fac, fft_size, hop,
                                            [0, 1], mix_down=True, device=dev)
    signal, sr, num_channels = audio_io.read_file(file_path)
    if num_channels != 2:
        raise ValueError("expects stereo input")
    n = len(signal)
    y_pad = fourier.fix_length(signal, n + fft_size // 2, axis=0)
    spec = fourier.stft(torch.as_tensor(np.ascontiguousarray(y_pad.T), device=dev),
                        n_fft=fft_size, step=hop)
    D_L, D_R = spec[0], spec[1]
    paths = []
    for op_type, mask in (("max", torch.abs(D_L) > torch.abs(D_R)),
                          ("min", torch.abs(D_L) < torch.abs(D_R))):
        y_out = fourier.istft(torch.where(mask, D_L, D_R), length=n, hop_length=hop)
        paths.append(audio_io.write_file(file_path, y_out.cpu().numpy(), sr, 1,
                                         suffix=op_type + suffix))
    return paths
