"""Harmonic / percussive / residual separation batch tool (counterpart of
pyaudiorestoration_tpu/pipelines/hpss_tool.py; reference:
experiments/hpss_gui.py:109-149).

Writes ``_H``, ``_P`` and (for margin > 1) ``_R`` component files.  In
memory, every selected channel goes through one batched STFT, one HPSS of
the (C, F, T) spectrogram and one batched iSTFT a component (JAX loops over
the channels); the streamed form runs the same masks through the port's
``stream_masked_stft``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import decompose, fourier
from ..utils import audio_io, streaming
from ..utils.timing import Stages
from ..utils.device import resolve_device

__all__ = ["separate", "separate_file"]


def separate(signal, sr, fft_size=2048, fft_overlap=4, kernel_size=31, power=2.0,
             margin=1.0, channels=None, device="cuda", timings=None):
    """HPSS of every channel; returns (harmonic, percussive, residual) host
    float32 arrays shaped like the selected-channel signal (the residual is
    zeros at margin 1).  ``timings``, a dict, receives the seconds of the
    upload, the STFT, the HPSS (both medians and the masks), the three
    iSTFTs and the download (``utils.timing.Stages``)."""
    dev = resolve_device(device)
    stages = Stages(timings, dev)
    hop = fft_size // fft_overlap
    channels = list(channels) if channels else list(range(signal.shape[1]))
    n = len(signal)
    padded = fourier.fix_length(signal, n + fft_size // 2, axis=0)
    x = torch.as_tensor(np.ascontiguousarray(padded[:, channels].T, dtype=np.float32),
                        device=dev)
    stages.mark("upload")
    spec = fourier.stft(x, n_fft=fft_size, step=hop)
    stages.mark("stft")
    H, P = decompose.hpss(spec, kernel_size=kernel_size, power=power, margin=margin)
    R = spec - H - P
    stages.mark("hpss")
    outs = [fourier.istft(comp, length=n, hop_length=hop).T.contiguous()
            for comp in (H, P, R)]
    stages.mark("istft")
    outs = [o.cpu().numpy() for o in outs]
    stages.mark("download")
    return outs


def separate_file(file_path, fft_size=2048, fft_overlap=4, kernel_size=31,
                  power=2.0, margin=1.0, channels=None, suffix="",
                  stream="auto", stream_threshold_bytes: int = 1 << 30, device="cuda",
                  timings=None):
    """Write the separated components next to the input.  Returns paths.

    ``stream``: True forces the blockwise larger-than-memory path (one pass,
    all components written together); "auto" streams when the decoded size
    exceeds ``stream_threshold_bytes``.  ``timings``, a dict, receives the
    in-memory path's seconds: read, :func:`separate`'s stages, write."""
    dev = resolve_device(device)
    if streaming.should_stream(file_path, stream, stream_threshold_bytes):
        return _separate_file_streamed(file_path, fft_size, fft_overlap, kernel_size,
                                       power, margin, channels, suffix, device=device)
    stages = Stages(timings, dev)
    signal, sr, num_channels = audio_io.read_file(file_path)
    stages.mark("read")
    H, P, R = separate(signal, sr, fft_size, fft_overlap, kernel_size, power, margin,
                       channels, device=device, timings=timings)
    stages = Stages(timings, dev)
    paths = [audio_io.write_file(file_path, H, sr, H.shape[1], "_H" + suffix),
             audio_io.write_file(file_path, P, sr, P.shape[1], "_P" + suffix)]
    if margin > 1.0:
        paths.append(audio_io.write_file(file_path, R, sr, R.shape[1], "_R" + suffix))
    stages.mark("write")
    return paths


def _separate_file_streamed(file_path, fft_size, fft_overlap, kernel_size, power,
                            margin, channels, suffix="", device="cuda"):
    """Streamed HPSS: the harmonic median runs along time, so each block
    carries a ``kernel_size // 2 + 1``-frame mask halo; the H/P(/R)
    components stream to their files in one pass over the input."""
    hop = fft_size // fft_overlap
    with audio_io.StreamReader(file_path) as r:
        chans = list(channels) if channels else list(range(r.channels))

    def make_fac(spec, t_lo):
        mh, mp = decompose.hpss(torch.abs(spec), kernel_size=kernel_size, power=power,
                                margin=margin, mask=True)
        return [mh, mp, 1.0 - mh - mp] if margin > 1.0 else [mh, mp]

    base, _ = os.path.splitext(file_path)
    ext = audio_io.out_ext()
    out_paths = [f"{base}_H{suffix}.{ext}", f"{base}_P{suffix}.{ext}"]
    if margin > 1.0:
        out_paths.append(f"{base}_R{suffix}.{ext}")
    return streaming.stream_masked_stft(file_path, out_paths, make_fac, fft_size, hop,
                                        chans, mask_halo_frames=kernel_size // 2 + 1,
                                        device=device)
