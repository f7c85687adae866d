"""Re-noising / denoise-repair (counterpart of
pyaudiorestoration_tpu/pipelines/renoiser.py; reference tool:
renoiser_gui.py).

A noise-floor dB profile (from a spectrogram selection or a noise file) plus
a control curve define a per-bin threshold; bins below it get a gain
(negative dB = denoise, positive = re-noise) (renoiser_gui.py:239-345).  The
masked STFT -> iSTFT round trip runs on the device for all channels in one
batched call.  ``sniff_offset`` scans the hop phases for the greatest
transient contrast (renoiser_gui.py:347-380) from one step-1 banded STFT.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..ops import fourier, resampling, units
from ..utils import audio_io, streaming
from ..utils.device import as_device_tensor, resolve_device
from ..utils.timing import Stages

__all__ = [
    "noise_profile_from_file", "noise_profile_from_selection", "final_profile",
    "get_mask_fac", "process", "process_file", "sniff_offset", "RenoisePreview",
]


class RenoisePreview:
    """Re-mask-only path for parameter sweeps (renoiser_gui.py:253-271): the
    complex spectrogram of one channel stays on the device; ``remask`` is
    one threshold-and-scale and returns the masked magnitude (the preview
    image), ``render`` inverts to audio only when asked."""

    def __init__(self, signal, sr, fft_size=1024, fft_overlap=4, channel=0,
                 device="cuda"):
        self.sr = sr
        self.fft_size = fft_size
        self.hop = fft_size // fft_overlap
        n = len(signal)
        self._n = n
        x = signal[:, channel] if signal.ndim == 2 else signal
        padded = fourier.fix_length(np.asarray(x, np.float32), n + fft_size // 2)
        self._spec = fourier.stft(padded, n_fft=fft_size, step=self.hop, device=device)
        self._mag = torch.abs(self._spec) + 1e-7
        self.freqs = fourier.fft_freqs(fft_size, sr)

    def magnitude(self):
        """The cached unmasked magnitude (host copy)."""
        return self._mag.cpu().numpy()

    def noise_profile_from_selection(self, t0, t1):
        return noise_profile_from_selection(self._mag, self.sr, self.hop, t0, t1)

    def _fac(self, profile, gain, control_curve, overhead):
        prof = final_profile(profile, self.freqs, control_curve, 0.0, overhead)
        return _mask_fac(20.0 * torch.log10(self._mag), _profile_tensor(prof, self._mag),
                         float(gain))

    def remask(self, profile, gain, control_curve=(), overhead=0.0):
        """Masked magnitude for the current parameters, no STFT recompute.
        Returns (num_bins, num_frames) float32 (host)."""
        return (self._mag * self._fac(profile, gain, control_curve, overhead)).cpu().numpy()

    def render(self, profile, gain, control_curve=(), overhead=0.0):
        """Masked iSTFT audio for the chosen parameters (single channel)."""
        fac = self._fac(profile, gain, control_curve, overhead)
        return fourier.istft(self._spec * fac, length=self._n,
                             hop_length=self.hop).cpu().numpy()


def _profile_tensor(profile, like):
    return torch.as_tensor(np.asarray(profile, np.float32), device=like.device)


def noise_profile_from_file(noise_path, sr, fft_size=1024, fft_overlap=4, zeropad=1,
                            device="cuda"):
    """Average dB spectrum of a noise file's first channel, resampled to
    ``sr`` when its rate differs (renoiser_gui.py:239-251)."""
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    noise, noise_sr, _ = audio_io.read_file(noise_path)
    x = torch.as_tensor(np.ascontiguousarray(noise[:, 0]), device=dev)
    if noise_sr != sr:
        x = resampling.resample_ratio(x, noise_sr, sr, device_out=True)
    mag = fourier.get_mag(x, fft_size, hop, "blackmanharris", zeropad=zeropad)
    return np.average(units.to_dB(mag.cpu().numpy()), axis=1)


def noise_profile_from_selection(spec_mag, sr, hop, t0, t1):
    """Average dB spectrum of a spectrogram time slice
    (renoiser_gui.py:327-345).  A tensor's slice is downloaded first, so
    the average is numpy's float32 one, as JAX's."""
    f0 = max(0, int(t0 * sr / hop))
    f1 = min(spec_mag.shape[1] - 1, int(t1 * sr / hop))
    sel = spec_mag[:, f0:f1]
    if isinstance(sel, torch.Tensor):
        sel = sel.cpu().numpy()
    return units.to_dB(np.average(np.ascontiguousarray(sel), axis=1))


def final_profile(noise_profile, freqs, control_curve=(), gain=0.0, overhead=0.0):
    """Threshold = floor + gain + control + overhead (renoiser_gui.py:306-312).
    ``control_curve``: iterable of (freq_hz, dB) points."""
    if len(control_curve):
        pts = sorted((float(f), float(d)) for f, d in control_curve)
        control = np.interp(freqs, [p[0] for p in pts], [p[1] for p in pts])
    else:
        control = 0.0
    return np.asarray(noise_profile) + gain + control + overhead


def _mask_fac(spec_db, profile, gain: float):
    """``gain`` dB where a bin is at or below its row's threshold, 0 dB above,
    as float32 factors; ``profile`` (F,) broadcasts over (..., F, T)."""
    gain_mask = torch.where(spec_db > profile[:, None], 0.0, gain)
    return torch.pow(10.0, gain_mask / 20.0).to(torch.float32)


def get_mask_fac(spec_mag, profile, gain, device="cuda"):
    """Gain factor per bin: ``gain`` dB below threshold, 0 dB above
    (renoiser_gui.py:273-278)."""
    mag = as_device_tensor(spec_mag, device)
    return _mask_fac(20.0 * torch.log10(mag), _profile_tensor(profile, mag), float(gain))


def _process_fused(x, profile, gain: float, fft_size: int, hop: int, length: int,
                   stages=Stages(None)):
    """Masked STFT -> iSTFT of the (C, n) tensor ``x``."""
    spec = fourier.stft(x, n_fft=fft_size, step=hop)
    stages.mark("stft")
    fac = _mask_fac(20.0 * torch.log10(torch.abs(spec) + 1e-7), profile, gain)
    stages.mark("mask")
    y = fourier.istft(spec * fac, length=length, hop_length=hop)
    stages.mark("istft")
    return y


def process(signal, sr, profile, gain, fft_size=1024, fft_overlap=4, channels=None,
            blockwise: int = 0, device="cuda", timings=None):
    """Masked STFT -> iSTFT of all selected channels in one batched call
    (renoiser_gui.py:296-319).

    ``blockwise``: process in blocks of this many frames with halo trim
    (``utils/streaming.stream_process``, the reference's 256 KB iSTFT
    blocking writ large, util/fourier.py:390-407), which bounds the device
    temporaries of big in-memory arrays; 0 processes the take at once.  (For
    file-to-file streaming use ``process_file(stream=True)``.)  ``timings``,
    a dict, receives the whole take's seconds (``blockwise`` 0): upload,
    STFT, mask, iSTFT, download (``utils.timing.Stages``)."""
    dev = resolve_device(device)
    stages = Stages(None if blockwise else timings, dev)
    hop = fft_size // fft_overlap
    channels = list(channels) if channels else list(range(signal.shape[1]))
    prof = torch.as_tensor(np.asarray(profile, np.float32), device=dev)

    def roundtrip(block):
        bn = len(block)
        padded = fourier.fix_length(block, bn + fft_size // 2, axis=0)
        x = torch.as_tensor(np.ascontiguousarray(padded[:, channels].T, dtype=np.float32),
                            device=dev)
        stages.mark("upload")
        # (n, C) rows on the device, so the writer gets a C-ordered array
        return _process_fused(x, prof, float(gain), fft_size, hop, bn, stages).T.contiguous()

    if blockwise:
        out = streaming.stream_process(signal, roundtrip, hop, blocksize=int(blockwise))
    else:
        out = roundtrip(signal).cpu().numpy()
        stages.mark("download")
    return out.astype(signal.dtype)


class _ArrayReader:
    """``StreamReader``'s ``frames`` and ``read`` over an in-memory signal."""

    def __init__(self, signal):
        self.signal = signal
        self.frames = len(signal)

    def read(self, start, count):
        return self.signal[start:start + count]


def _selection_profile(reader, sr, fft_size, hop, t0, t1, device):
    """The floor of the frames ``t0``-``t1`` of channel 0, read on the global
    frame grid of the centred STFT (``noise_profile_from_selection`` of the
    whole channel's magnitude).  The in-memory and the streamed paths both
    take it, so their frames go through one FFT of one shape and the
    profile, and thus every masked bin, is the same in both: an FFT's
    rounding may depend on its batch."""
    pad = fft_size // 2
    n = int(reader.frames)
    T_sel = (n + 2 * pad - fft_size) // hop + 1
    f0 = max(0, int(t0 * sr / hop))
    f1 = max(f0 + 1, min(T_sel - 1, int(t1 * sr / hop)))
    a = f0 * hop - pad
    b = (f1 - 1) * hop - pad + fft_size
    span = streaming.virtual_read(reader, a, b, 0, [0])[:, 0]
    mag = fourier.get_mag(span, fft_size, hop, center=False, device=device)
    return units.to_dB(np.average(mag[:, :f1 - f0].cpu().numpy(), axis=1))


def process_file(file_path, noise_path=None, selection=None, control_curve=(),
                 gain=-40.0, overhead=0.0, fft_size=1024, fft_overlap=4,
                 channels=None, suffix=None, stream="auto",
                 stream_threshold_bytes: int = 1 << 30, device="cuda", timings=None):
    """One-call renoise/denoise of a file.  ``selection``: (t0, t1) noise span
    in the file itself; otherwise ``noise_path`` supplies the floor.

    ``stream``: True forces the blockwise larger-than-memory path (interior
    equality with the in-memory path, ``utils/streaming.stream_masked_stft``);
    "auto" streams when the decoded size exceeds ``stream_threshold_bytes``.
    ``timings``, a dict, receives the in-memory path's seconds: read, the
    noise profile, :func:`process`'s stages, write."""
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    sfx = suffix if suffix is not None else f" fft={fft_size}"
    if streaming.should_stream(file_path, stream, stream_threshold_bytes):
        with audio_io.StreamReader(file_path) as r:
            sr, num_channels = r.sample_rate, r.channels
            if noise_path:
                profile = noise_profile_from_file(noise_path, sr, fft_size, fft_overlap,
                                                  device=dev)
            elif selection:
                profile = _selection_profile(r, sr, fft_size, hop, *selection, dev)
            else:
                raise ValueError("need noise_path or selection")
        profile = final_profile(profile, fourier.fft_freqs(fft_size, sr), control_curve,
                                0.0, overhead)
        prof = torch.as_tensor(np.asarray(profile, np.float32), device=dev)
        chans = list(channels) if channels else list(range(num_channels))

        def make_fac(spec, t_lo):
            return _mask_fac(20.0 * torch.log10(torch.abs(spec) + 1e-7), prof,
                             float(gain))

        base, _ = os.path.splitext(file_path)
        return streaming.stream_masked_stft(file_path, f"{base}{sfx}.{audio_io.out_ext()}",
                                            make_fac, fft_size, hop, chans, device=dev)
    stages = Stages(timings, dev)
    signal, sr, num_channels = audio_io.read_file(file_path)
    stages.mark("read")
    if noise_path:
        profile = noise_profile_from_file(noise_path, sr, fft_size, fft_overlap,
                                          device=dev)
    elif selection:
        profile = _selection_profile(_ArrayReader(signal), sr, fft_size, hop, *selection,
                                     dev)
    else:
        raise ValueError("need noise_path or selection")
    profile = final_profile(profile, fourier.fft_freqs(fft_size, sr), control_curve,
                            0.0, overhead)
    stages.mark("profile")
    out = process(signal, sr, profile, gain, fft_size, fft_overlap, channels, device=dev,
                  timings=timings)
    stages = Stages(timings, dev)
    path = audio_io.write_file(file_path, out, sr, out.shape[1], sfx)
    stages.mark("write")
    return path


def _band_gain_positions(xp, fft_size: int, lo: int, hi: int, n_pos: int, chunk: int):
    """Band-mean |FFT| of the frame starting at every sample position of the
    1-D tensor ``xp``: a step-1 banded STFT, ``chunk`` positions at a time,
    each chunk's frames an ``unfold(0, fft_size, 1)`` view (no gather) so
    memory holds one (chunk, fft_size) block."""
    window = torch.as_tensor(fourier.get_window("blackmanharris", fft_size),
                             device=xp.device)
    need = -(-n_pos // chunk) * chunk + fft_size
    if xp.shape[0] < need:
        xp = torch.cat([xp, xp.new_zeros(need - xp.shape[0])])
    scale = math.sqrt(fft_size)
    out = []
    for a in range(0, n_pos, chunk):
        frames = xp[a:a + chunk + fft_size - 1].unfold(0, fft_size, 1) * window
        spec = torch.fft.rfft(frames, dim=-1) / scale
        out.append(torch.mean(torch.abs(spec[:, lo:hi]), dim=-1))
    return torch.cat(out)[:n_pos]


def sniff_offset(signal, sr, fft_size=1024, fft_overlap=4, f_lo=3000, f_hi=12000,
                 device="cuda"):
    """The hop phase that maximises the band energy's variance
    (renoiser_gui.py:347-380).  Returns the optimal pad offset.

    All ``hop`` phases come from one step-1 banded STFT: the band gain at
    every sample position, phase i's frames being every hop-th position
    from -i.  The variance is scored over the frames whose windows lie
    inside the signal for every phase, so no phase gains or loses boundary
    frames.  The positions go in blocks of 128 MiB of frames."""
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    sig = np.asarray(signal[:, 0] if signal.ndim == 2 else signal, np.float32)
    lo = int(round(f_lo * fft_size / sr))
    hi = int(round(f_hi * fft_size / sr))
    n = len(sig)
    T = (n + fft_size // 2) // hop + 1
    # frame at signal position q starts at xp[q + hop - 1] covering
    # [q - fft//2, q + fft//2); front zeros serve every phase shift
    xp = torch.as_tensor(np.pad(sig, (hop - 1 + fft_size // 2, fft_size)), device=dev)
    g = _band_gain_positions(xp, fft_size, lo, hi, T * hop, max(1, (1 << 25) // fft_size))
    # row t column c is position q = t*hop + c - (hop-1); keep the rows whose
    # positions are >= fft//2 and <= n - fft//2 for every c
    t_lo = -(-(fft_size // 2 + hop - 1) // hop)
    t_hi = (n - fft_size // 2) // hop + 1
    rows = g.reshape(T, hop)
    if t_hi - t_lo >= 4:
        rows = rows[t_lo:t_hi]
    stds_by_col = torch.std(rows, dim=0, correction=0)
    # phase i reads column hop-1-i
    return int(torch.argmax(torch.flip(stds_by_col, (0,))))
