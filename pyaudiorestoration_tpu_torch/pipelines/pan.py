"""Pan matching (counterpart of pyaudiorestoration_tpu/pipelines/pan.py;
reference tool: pypan_gui.py).

Mark time-frequency boxes, measure the L/R magnitude ratio inside each
(pypan_gui.py:79-104), interpolate a pan factor curve, and rescale channel 1
(pypan_gui.py:53-58).  Both channels' spectra come from one batched STFT on
the device; the gain curve is host float64 (``np.interp``, as JAX) and the
float64 multiply runs on the device, which rounds it as numpy does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import markers as mk
from ..ops import fourier
from ..utils import audio_io, streaming
from ..utils.device import resolve_device

__all__ = ["measure_pan", "apply_pan", "pan_file"]


def measure_pan(signal, sr, a, b, fft_size=1024, fft_overlap=4, spectra=None,
                device="cuda"):
    """L/R magnitude ratio inside box (a, b) -> PanSample (pypan_gui.py:79-104).
    ``spectra``: optional precomputed (L, R) magnitudes, host or device."""
    hop = fft_size // fft_overlap
    if spectra is None:
        x = np.ascontiguousarray(np.asarray(signal)[:, :2].T, dtype=np.float32)
        L, R = torch.abs(fourier.stft(x, fft_size, hop, device=device)) + 1e-7
    else:
        L, R = spectra
    num_bins, last_fft_i = L.shape
    t0, t1 = sorted((a[0], b[0]))
    freqs = sorted((a[1], b[1]))
    fL = max(freqs[0], 1)
    fU = min(freqs[1], sr // 2 - 1)
    first_fft_i = max(0, int(t0 * sr / hop)) if t0 else 0
    last_fft_i = min(last_fft_i, int(t1 * sr / hop)) if t1 else last_fft_i

    def freq2bin(f):
        return max(1, min(num_bins - 3, int(round(f * fft_size / sr))))

    bL, bU = freq2bin(fL), freq2bin(fU)
    box = [np.asarray(s[bL:bU, first_fft_i:last_fft_i].cpu()
                      if isinstance(s, torch.Tensor) else s[bL:bU, first_fft_i:last_fft_i])
           for s in (L, R)]
    return mk.PanSample(a, b, float(np.nanmean(box[0] / box[1])))


def _pan_factor(data, sr, s0, s1):
    """The pan curve at samples [s0, s1), host float64."""
    return np.interp(np.arange(s0, s1, dtype=np.float64), data[:, 0] * sr, data[:, 1])


def _scaled(channel, af, dev):
    """``channel * af`` in float64 on ``dev`` (one rounding, as numpy's)."""
    x = torch.as_tensor(np.ascontiguousarray(channel), device=dev)
    return (x.to(torch.float64) * torch.as_tensor(af, device=dev)).cpu().numpy()


def apply_pan(signal, sr, pan_samples, hop=256, device="cuda"):
    """Interpolate the pan curve and rescale channel 1 (pypan_gui.py:53-58).
    Returns the mono float64 output ``signal[:, 1] * pan_factor``."""
    dev = resolve_device(device)
    line = mk.PanLine(sr, hop, len(signal) / sr)
    data = line.update(list(pan_samples))
    return _scaled(signal[:, 1], _pan_factor(data, sr, 0, len(signal)), dev)


def pan_file(file_path, pan_samples, hop=256, stream="auto",
             stream_threshold_bytes: int = 1 << 30, device="cuda"):
    """Write ``<input>_out`` with channel 1 rescaled by the pan curve.
    ``stream``: blockwise application for big files (the gain curve is
    frame-rate host data; channel 1 rescales block by block)."""
    dev = resolve_device(device)
    if streaming.should_stream(file_path, stream, stream_threshold_bytes):
        with audio_io.StreamReader(file_path) as r:
            sr = r.sample_rate
            n = int(r.frames)
            data = mk.PanLine(sr, hop, n / sr).update(list(pan_samples))
            base, _ = os.path.splitext(file_path)
            out_path = f"{base}_out.{audio_io.out_ext()}"
            blk = 1 << 22
            with audio_io.open_writer(out_path, sr, 1) as w:
                for s0 in range(0, n, blk):
                    s1 = min(n, s0 + blk)
                    buf = r.read(s0, s1 - s0)
                    out = _scaled(buf[:, 1], _pan_factor(data, sr, s0, s1), dev)
                    w.write(out.astype(np.float32)[:, None])
        return out_path
    signal, sr, num_channels = audio_io.read_file(file_path)
    out = apply_pan(signal, sr, pan_samples, hop, device=dev)
    return audio_io.write_file(file_path, out, sr, 1)
