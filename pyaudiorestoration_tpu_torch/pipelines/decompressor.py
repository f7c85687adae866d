"""Dynamics matching / decompression against a reference master (counterpart
of pyaudiorestoration_tpu/pipelines/decompressor.py; reference:
experiments/decompressor_cmd.py).

Windowed-RMS envelopes of source and reference (band-passed), log-domain
level matching, optional per-window xcorr re-sync, gain factors clipped to
[0, 2], interpolated to sample rate and applied.  The band-pass and the
frame-rate gain curve are host float64 (scipy and numpy, as JAX); the
windowed RMS is a framed reduction on the device and the sync pass one
batched ``find_delay_batch``.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from scipy.ndimage import uniform_filter1d

from ..ops import correlation, filters
from ..utils import audio_io, streaming
from ..utils.device import as_device_tensor, resolve_device

__all__ = ["windowed_rms", "match_dynamics", "decompress_file"]

RMS_WINDOWS_PER_CHUNK = 1 << 16  # bounds the (windows, sz) frame block


def _windowed_rms_device(x, hop: int, sz: int, n_valid: int = None):
    """RMS of the windows ``x[i*hop : i*hop + sz]`` for i < ceil(n_valid /
    hop), each over its samples below ``n_valid`` (the reference's trailing
    windows are shorter).  ``x``: 1-D float32 tensor."""
    if n_valid is None:
        n_valid = x.shape[0]
    n_win = -(-n_valid // hop)  # ceil, matching the reference's range()
    total = (n_win - 1) * hop + sz
    # samples past n_valid are zeroed: they add nothing to a window's sum
    xp = torch.cat([x[:n_valid], x.new_zeros(max(0, total - n_valid))])
    count = torch.clamp(n_valid - torch.arange(n_win, device=x.device) * hop, max=sz)
    sums = []
    for a in range(0, n_win, RMS_WINDOWS_PER_CHUNK):
        b = min(n_win, a + RMS_WINDOWS_PER_CHUNK)
        frames = xp[a * hop:(b - 1) * hop + sz].unfold(0, sz, hop)
        sums.append(torch.sum(frames * frames, dim=1))
    return torch.sqrt(torch.cat(sums) / count)


def windowed_rms(signal, hop=32, sz=512, device="cuda"):
    """RMS per hop window (decompressor_cmd.py:16-23), host float32."""
    x = as_device_tensor(np.asarray(signal, np.float32), device)
    return _windowed_rms_device(x, hop, sz).cpu().numpy()


def match_dynamics(signal_src, signal_ref, sr, hop=32, sz=512, corr_sz=4096,
                   smoothing_sec=0.08, lower=80.0, upper=9000.0, do_sync=False,
                   device="cuda"):
    """Per-channel gain curve transferring the reference's dynamics onto the
    source (decompressor_cmd.py:26-190).  Returns the processed source."""
    dev = resolve_device(device)
    n = min(len(signal_src), len(signal_ref))
    signal_src = np.asarray(signal_src[:n], np.float32)
    signal_ref = np.asarray(signal_ref[:n], np.float32)
    if signal_src.ndim == 1:
        signal_src = signal_src[:, None]
    if signal_ref.ndim == 1:
        signal_ref = signal_ref[:, None]
    fac_interp = np.empty(signal_src.shape)
    for channel in range(signal_src.shape[1]):
        # host, as JAX: the envelope chain downstream is numpy float64
        src_c = filters.butter_bandpass_filter(signal_src[:, channel], lower, upper, sr,
                                               order=3, backend="host")
        ref_c = filters.butter_bandpass_filter(signal_ref[:, channel], lower, upper, sr,
                                               order=3, backend="host")
        rms_src = windowed_rms(src_c, hop, sz, device=dev)
        rms_ref = windowed_rms(ref_c, hop, sz, device=dev)
        fac = _fac_from_rms(rms_src, rms_ref, sr, hop, corr_sz, smoothing_sec, do_sync,
                            device=dev)
        fac_interp[:, channel] = np.interp(
            np.arange(n), np.arange(0, n, hop)[:len(fac)], fac[: len(range(0, n, hop))])
    fac_interp = np.mean(fac_interp, axis=-1, keepdims=True)
    return (signal_src * fac_interp).astype(np.float32)


def _fac_from_rms(rms_src, rms_ref, sr, hop, corr_sz, smoothing_sec, do_sync,
                  device="cuda"):
    """Envelope pair -> clipped gain-factor curve (decompressor_cmd.py:
    98-160), the frame-rate control plane shared by the in-memory and
    streamed paths.  Host float64 but for the sync pass's delays."""
    corr_hop = corr_sz // 2
    smooth_n = max(1, int(sr * smoothing_sec / hop))
    hann = np.hanning(corr_sz)
    rms_src = np.log10(np.clip(rms_src, 0.0005, None))
    rms_ref = np.log10(np.clip(rms_ref, 0.0005, None))
    rms_ref = rms_ref - np.mean(rms_ref) + np.mean(rms_src)
    rms_src = uniform_filter1d(rms_src, size=smooth_n)
    rms_ref = uniform_filter1d(rms_ref, size=smooth_n)
    if do_sync:
        # windowed re-alignment of the source envelope (one batched xcorr)
        src_p = np.pad(rms_src, (corr_hop, corr_hop * 2), "edge")
        ref_p = np.pad(rms_ref, (corr_hop, corr_hop * 2), "edge")
        xs = np.arange(corr_hop, len(rms_src), corr_hop)
        ref_wins = np.stack([ref_p[x - corr_hop:x + corr_hop] * hann for x in xs])
        src_wins = np.stack([src_p[x - corr_hop:x + corr_hop] * hann for x in xs])
        aligned = np.zeros(src_p.shape)
        delays, corrs = correlation.find_delay_batch(ref_wins, src_wins, device=device)
        last = 0
        for x, win, d, c in zip(xs, src_wins, delays.cpu().numpy(), corrs.cpu().numpy()):
            offset = int(round(float(d))) if float(c) > 0.1 else last
            last = offset
            aligned[x - corr_hop:x + corr_hop] += np.roll(win, offset)
        rms_src_aligned = aligned[corr_hop:-corr_hop * 2]
    else:
        rms_src_aligned = rms_src
    fac = np.power(10, rms_ref) / np.power(10, rms_src_aligned)
    np.clip(fac, 0, 2, fac)
    np.nan_to_num(fac, copy=False)
    return fac


def _streamed_rms_envelopes(path, n, lower, upper, hop, sz, halo_seconds=0.5,
                            block=1 << 22, device="cuda"):
    """Per-channel band-passed RMS envelopes, blockwise (IIR halo trim; RMS
    windows read a ``sz`` right halo so every window sees its true samples).
    Frame-rate output: (C, ceil(n/hop)) float32."""
    dev = resolve_device(device)
    with audio_io.StreamReader(path) as r:
        sr = r.sample_rate
        C = r.channels
        halo = int(halo_seconds * sr)
        n_win = -(-n // hop)
        out = np.empty((C, n_win), np.float32)
        for s0 in range(0, n, block):
            s1 = min(n, s0 + block)
            lo = max(0, s0 - halo)
            hi = min(n, s1 + halo + sz)
            buf = r.read(lo, hi - lo).astype(np.float64)
            w_lo = -(-s0 // hop)
            w_hi = -(-s1 // hop) if s1 < n else n_win
            for c in range(C):
                band = filters.butter_bandpass_filter(buf[:, c], lower, upper, sr,
                                                      order=3, backend="host")
                seg = torch.as_tensor(band[s0 - lo:], device=dev)
                # windows starting in [s0, s1); n_valid clamps the global end
                rms = _windowed_rms_device(seg, hop, sz, n_valid=min(len(seg), n - s0))
                out[c, w_lo:w_hi] = rms[: w_hi - w_lo].cpu().numpy()
    return out


def decompress_file(src_path, ref_path, stream="auto",
                    stream_threshold_bytes: int = 1 << 30, device="cuda", **kwargs):
    """Write ``<src>_decompressed`` with the reference's dynamics.

    ``stream``: the blockwise larger-than-memory path: band-passed RMS
    envelopes accumulate per block (the whole-recording state is the
    frame-rate envelope, 4 bytes per hop per channel), the gain curve is
    host math, and the multiply streams to the writer."""
    dev = resolve_device(device)
    use_stream = (streaming.should_stream(src_path, stream, stream_threshold_bytes)
                  or streaming.should_stream(ref_path, stream, stream_threshold_bytes))
    if not use_stream:
        src, sr, _ = audio_io.read_file(src_path)
        ref, sr2, _ = audio_io.read_file(ref_path)
        if sr != sr2:
            raise ValueError("Both files must have the same sample rate")
        out = match_dynamics(src, ref, sr, device=dev, **kwargs)
        return audio_io.write_file(src_path, out, sr, out.shape[1], suffix="_decompressed")
    hop = kwargs.get("hop", 32)
    sz = kwargs.get("sz", 512)
    lower = kwargs.get("lower", 80.0)
    upper = kwargs.get("upper", 9000.0)
    with audio_io.StreamReader(src_path) as rs, audio_io.StreamReader(ref_path) as rr:
        if rs.sample_rate != rr.sample_rate:
            raise ValueError("Both files must have the same sample rate")
        sr = rs.sample_rate
        n = min(int(rs.frames), int(rr.frames))
        C = rs.channels
    rms_src = _streamed_rms_envelopes(src_path, n, lower, upper, hop, sz, device=dev)
    rms_ref = _streamed_rms_envelopes(ref_path, n, lower, upper, hop, sz, device=dev)
    facs = np.stack([
        _fac_from_rms(rms_src[c], rms_ref[min(c, rms_ref.shape[0] - 1)], sr, hop,
                      kwargs.get("corr_sz", 4096), kwargs.get("smoothing_sec", 0.08),
                      kwargs.get("do_sync", False), device=dev)
        for c in range(C)])
    base, _ = os.path.splitext(src_path)
    out_path = f"{base}_decompressed.{audio_io.out_ext()}"
    blk = 1 << 22
    grid = np.arange(0, n, hop, dtype=np.float64)[: facs.shape[1]]
    with audio_io.StreamReader(src_path) as r, audio_io.open_writer(out_path, sr, C) as w:
        for s0 in range(0, n, blk):
            s1 = min(n, s0 + blk)
            buf = r.read(s0, s1 - s0)
            idx = np.arange(s0, s1, dtype=np.float64)
            fi = np.stack([np.interp(idx, grid, facs[c]) for c in range(C)], axis=-1)
            fi = np.mean(fi, axis=-1, keepdims=True)
            w.write((buf * fi).astype(np.float32))
    logging.info(f"Wrote {out_path}")
    return out_path
