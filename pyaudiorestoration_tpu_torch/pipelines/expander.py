"""Spectral expander / decompressor (counterpart of
pyaudiorestoration_tpu/pipelines/expander.py; reference tool:
expander_gui.py).

Band-mean dB envelope -> clip range -> per-sample gain factor, with an
optional high/low split so only the highs are boosted
(expander_gui.py:116-142, 178-210).  In memory, the spectra, the gain
multiply, the split filters (the float64 device ``sosfiltfilt``) and the
peak normalisation run on the device for all channels at once; the band
mean, its smoothing and the float64 gain interpolation stay on the host, as
in JAX.  The streamed path keeps JAX's host float64 block loop around a
device pass for the envelopes.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from scipy.ndimage import uniform_filter1d

from ..models.spectrum_flat import _channels, channel_map, db_spectra
from ..ops import filters, fourier, units
from ..utils import audio_io, streaming
from ..utils.device import resolve_device
from ..utils.timing import Stages

__all__ = ["envelope_curves", "expand", "expand_file"]


def _freq2bin(f, fft_size, sr, num_bins):
    return max(1, min(num_bins - 3, int(round(f * fft_size / sr))))


def envelope_curves(file_src, channel_mode="L+R", fft_size=512, fft_hop=None,
                    band_lower=13000, band_upper=17000, smoothing_s=0.11,
                    device="cuda", timings=None):
    """Per-channel smoothed band-mean dB envelopes (expander_gui.py:116-142).

    Returns (t, vol_curves, sr): times per FFT frame + dB curve per channel.
    Only the band's rows of the dB spectra are downloaded.  ``timings``, a
    dict, receives the seconds of the read, the spectra (upload, STFT, dB),
    the band's download and the host envelope (``utils.timing.Stages``).
    """
    fft_hop = fft_hop or fft_size // 8
    stages = Stages(timings, resolve_device(device))
    signal, sr, num_channels = audio_io.read_file(file_src)
    stages.mark("read")
    num_bins = fft_size // 2 + 1
    bL = _freq2bin(band_lower, fft_size, sr, num_bins)
    bU = _freq2bin(band_upper, fft_size, sr, num_bins)
    db = db_spectra(signal, _channels(channel_mode, num_channels), fft_size, fft_hop,
                    device)
    stages.mark("spectra")
    n_frames = db.shape[-1]
    bands = list(db[:, bL:bU, :].cpu().numpy())
    stages.mark("band_download")
    if channel_mode == "Mean":
        bands = [np.mean(bands, axis=0)]
    smoothing = filters.make_odd(int(smoothing_s * sr / fft_hop))
    vol_curves = [uniform_filter1d(np.nanmean(band, axis=0), size=smoothing,
                                   mode="nearest") for band in bands]
    t = np.arange(0, fft_hop * n_frames, fft_hop) / sr
    stages.mark("envelope")
    return t, vol_curves, sr


def expand(signal, sr, t, vol_curves, clip_lower=-120, clip_upper=-85,
           transition=0, order=1, device="cuda", timings=None):
    """Apply the expansion gain to every channel (expander_gui.py:178-210),
    all channels in one device pass.  Returns the peak-normalized expanded
    signal, (n, C) float32 numpy.  ``timings``, a dict, receives the seconds
    of the host gain interpolation, the upload, the device gain (with the
    split filters and the normalization) and the download."""
    dev = resolve_device(device)
    stages = Stages(timings, dev)
    signal = np.asarray(signal, dtype=np.float32)
    n, num_channels = signal.shape
    fac = np.empty((num_channels, n))
    for channel_i in range(num_channels):
        dBs = vol_curves[channel_i] if channel_i < len(vol_curves) else vol_curves[-1]
        gain = units.to_fac(clip_upper - np.clip(dBs, clip_lower, clip_upper))
        fac[channel_i] = np.interp(np.arange(n), t * sr, gain)
    stages.mark("host_gain")
    sig = torch.as_tensor(np.ascontiguousarray(signal.T), device=dev)
    fac = torch.as_tensor(fac, device=dev)
    stages.mark("upload")
    boosted = sig.to(torch.float64) * fac
    if transition:
        lp = filters.butter_bandpass_filter(sig, 0, transition, sr, order=order)
        hp = filters.butter_bandpass_filter(boosted, transition, sr // 2, sr, order=order)
        out = lp + hp
    else:
        out = boosted
    out = units.normalize(out.to(torch.float32)).T.contiguous()  # (n, C) rows for the writer
    stages.mark("gain")
    out = out.cpu().numpy()
    stages.mark("download")
    return out


def expand_file(file_src, channel_mode="L+R", fft_size=512, band_lower=13000,
                band_upper=17000, clip_lower=-120, clip_upper=-85,
                smoothing_s=0.11, transition=0, order=1, suffix="_decompressed",
                stream="auto", stream_threshold_bytes: int = 1 << 30, device="cuda",
                timings=None):
    """One-call spectral decompression of a file (the tool's export path).

    ``stream``: True forces the blockwise larger-than-memory path; "auto"
    streams when the decoded size exceeds ``stream_threshold_bytes``.
    ``timings``, a dict, receives the in-memory path's seconds: the stages
    of :func:`envelope_curves`, the second read (as JAX's, the entry reads
    the file twice), those of :func:`expand`, and the write."""
    dev = resolve_device(device)
    if streaming.should_stream(file_src, stream, stream_threshold_bytes):
        return _expand_file_streamed(file_src, channel_mode, fft_size, band_lower,
                                     band_upper, clip_lower, clip_upper, smoothing_s,
                                     transition, order, suffix, device=device)
    t, vol_curves, sr = envelope_curves(file_src, channel_mode, fft_size,
                                        band_lower=band_lower, band_upper=band_upper,
                                        smoothing_s=smoothing_s, device=device,
                                        timings=timings)
    stages = Stages(timings, dev)
    signal, sr, num_channels = audio_io.read_file(file_src)
    stages.mark("reread")
    out = expand(signal, sr, t, vol_curves, clip_lower, clip_upper, transition, order,
                 device=device, timings=timings)
    stages = Stages(timings, dev)
    path = audio_io.write_file(file_src, out, sr, num_channels, suffix)
    stages.mark("write")
    return path


def _expand_file_streamed(file_src, channel_mode, fft_size, band_lower,
                          band_upper, clip_lower, clip_upper, smoothing_s,
                          transition, order, suffix,
                          block_frames: int = 16384, halo_seconds: float = 0.5,
                          device="cuda"):
    """Larger-than-memory expansion in three streamed passes
    (expander.py:93-194): frame-exact band envelopes on the device (the only
    whole-recording state, ~8 bytes/frame/channel), blockwise host float64
    gain + optional HP/LP split (scipy) with an IIR halo, then the global
    peak normalization applied while copying the temp output into place."""
    dev = resolve_device(device)
    fft_hop = fft_size // 8
    pad = fft_size // 2
    with audio_io.StreamReader(file_src) as r:
        sr = r.sample_rate
        n = int(r.frames)
        num_channels = r.channels
        chans = [c for c in channel_map[channel_mode] if c < num_channels] or [0]
        T = (n + 2 * pad - fft_size) // fft_hop + 1
        num_bins = fft_size // 2 + 1
        bL = _freq2bin(band_lower, fft_size, sr, num_bins)
        bU = _freq2bin(band_upper, fft_size, sr, num_bins)
        vols = np.empty((len(chans), T), np.float64)
        # ---- pass 1: frame-exact band envelopes, blockwise
        for t0 in range(0, T, block_frames):
            t1 = min(T, t0 + block_frames)
            a = t0 * fft_hop - pad
            b = (t1 - 1) * fft_hop - pad + fft_size
            span = torch.as_tensor(streaming.virtual_read(r, a, b, 0, chans).T, device=dev)
            db = units.to_dB(fourier.get_mag(span, fft_size, fft_hop, "hann",
                                             center=False))
            vols[:, t0:t1] = np.nanmean(db[:, bL:bU, :].cpu().numpy(), axis=1)
        smoothing = filters.make_odd(int(smoothing_s * sr / fft_hop))
        vol_curves = [uniform_filter1d(v, size=smoothing, mode="nearest") for v in vols]
        if channel_mode == "Mean":
            vol_curves = [np.mean(vol_curves, axis=0)]
        t_frames = np.arange(T, dtype=np.float64) * fft_hop

        # ---- pass 2: blockwise gain (+ split filters), peak tracked
        base, _ = os.path.splitext(file_src)
        out_path = f"{base}{suffix}.{audio_io.out_ext()}"
        # the unnormalized intermediate stays float32 WAV (it is re-read and
        # scaled in pass 3; quantizing it would double the rounding)
        tmp_path = out_path + ".unnorm.tmp"
        halo = int(halo_seconds * sr)
        blk = block_frames * fft_hop
        peak = 0.0
        facs = []
        for channel_i in range(num_channels):
            dBs = vol_curves[channel_i] if channel_i < len(vol_curves) else vol_curves[-1]
            facs.append(units.to_fac(clip_upper - np.clip(dBs, clip_lower, clip_upper)))
        with audio_io.StreamWriter(tmp_path, sr, num_channels) as w:
            for s0 in range(0, n, blk):
                s1 = min(n, s0 + blk)
                lo = max(0, s0 - halo)
                hi = min(n, s1 + halo)
                sig = r.read(lo, hi - lo).astype(np.float64)  # (len, C)
                idx = np.arange(lo, hi, dtype=np.float64)
                for channel_i in range(num_channels):
                    boosted = sig[:, channel_i] * np.interp(idx, t_frames, facs[channel_i])
                    if transition:
                        # host, as JAX: the block loop is host float64 either
                        # side of the filter (read -> gain -> writer)
                        lp = filters.butter_bandpass_filter(
                            sig[:, channel_i], 0, transition, sr, order=order,
                            backend="host")
                        hp = filters.butter_bandpass_filter(
                            boosted, transition, sr // 2, sr, order=order, backend="host")
                        sig[:, channel_i] = lp + hp
                    else:
                        sig[:, channel_i] = boosted
                out = sig[s0 - lo:(s0 - lo) + (s1 - s0)].astype(np.float32)
                peak = max(peak, float(np.abs(out).max()) if out.size else 0.0)
                w.write(out)
        # ---- pass 3: normalize while copying into place
        scale = 1.0 / peak if peak > 0 else 1.0
        with audio_io.StreamReader(tmp_path) as rt, \
                audio_io.open_writer(out_path, sr, num_channels) as w:
            nt_ = int(rt.frames)
            for s0 in range(0, nt_, blk):
                s1 = min(nt_, s0 + blk)
                w.write(rt.read(s0, s1 - s0) * np.float32(scale))
        os.remove(tmp_path)
    logging.info(f"Wrote {out_path}")
    return out_path
