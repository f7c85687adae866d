"""The port's larger-than-memory paths (counterpart of
``pyaudiorestoration_tpu/utils/streaming.py``): the auto-stream threshold on
the decoded size, the reads of the virtual padded signal, the streamed
masked-STFT engine, and the blockwise tracker and processor with halo trim
of the reference tool (experiments/pyrespeeder_cmd.py:16-49)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import audio_io
from .device import resolve_device

__all__ = ["decoded_bytes", "should_stream", "virtual_read", "stream_masked_stft",
           "iter_blocks", "stream_trace", "stream_process"]


def decoded_bytes(path) -> int:
    """Decoded float32 size of an audio file from its header (frames x
    channels x 4): container bytes undercount FLAC badly.  Uses the codec's
    header-only probe; a FLAC without a STREAMINFO total opens a reader."""
    try:
        _, ch, frames = audio_io.probe_file(path)
        if frames > 0:
            return frames * ch * 4
    except OSError:
        pass
    with audio_io.StreamReader(path) as r:
        return int(r.frames) * int(r.channels) * 4


def should_stream(path, stream="auto", threshold_bytes: int = 1 << 30) -> bool:
    """Resolve a ``stream`` flag: True/False pass through; "auto" streams
    when the decoded size exceeds ``threshold_bytes``."""
    if stream is True or stream is False:
        return stream
    return decoded_bytes(path) > threshold_bytes


def virtual_read(reader, a: int, b: int, pad: int, channels):
    """Read samples [a, b) of the virtual padded signal the in-memory
    spectral tools transform: ``fix_length(x, n + pad)`` (right zero pad)
    followed by the STFT's reflect centring (streaming.py:44-66).  Negative
    and past-end indices reflect as ``jnp.pad(mode="reflect")`` does, so
    blockwise frames equal the whole-file ones.  Returns (b - a, C) float32."""
    n = int(reader.frames)
    n_pad = n + pad
    idx = np.arange(a, b)
    idx = np.where(idx < 0, -idx, idx)                        # left reflect
    idx = np.where(idx >= n_pad, 2 * (n_pad - 1) - idx, idx)  # right reflect
    # spans can outrun even the reflected range (fixed-shape tail blocks on
    # short files); those frames are zeroed by the caller, so clamp
    idx = np.clip(idx, 0, max(n_pad - 1, 0))
    out = np.zeros((b - a, len(channels)), np.float32)
    real = idx < n
    if real.any():
        lo = int(idx[real].min())
        hi = int(idx[real].max())
        buf = reader.read(lo, hi - lo + 1)
        out[real] = buf[idx[real] - lo][:, channels]
    return out


def stream_masked_stft(in_path, out_path, make_fac, fft_size: int, hop: int,
                       channels=None, block_frames: int = 8192,
                       mask_halo_frames: int = 0, zeropad: int = 1,
                       window_name: str = "blackmanharris", progress=None,
                       mix_down: bool = False, device="cuda"):
    """Blockwise STFT -> per-bin gain mask -> iSTFT with halo trim, streamed
    file to file (streaming.py:69-173): the big-file path of heal and the
    max/min mono folds.

    Interior bit-parity with the in-memory ``stft(fix_length(x, n+pad))`` ->
    mask -> ``istft(length=n)`` round trip: each output sample's frame set,
    window-envelope addends and overlap-add order are the same, so the
    streamed file equals the in-memory one except where the mask itself is
    non-local (``mask_halo_frames`` bounds that reach).

    ``make_fac(spec_block, t_lo)``: the complex (C, F, T_blk) tensor of
    frames from global frame ``t_lo``, on ``device`` -> gain factors
    broadcastable to it, or a list of them when ``out_path`` is a list (one
    output file each).  ``mix_down`` sums the masked channels into one
    output channel a file.  The masked spectrum stays on the device; only
    the real output block is downloaded.  The window envelope is a host
    float64 accumulation in JAX's order.  Memory: one block."""
    from ..ops import fourier

    dev = resolve_device(device)
    multi = isinstance(out_path, (list, tuple))
    out_paths = list(out_path) if multi else [out_path]
    pad = fft_size // 2
    tiny = np.finfo(np.float32).tiny
    win_sq = fourier.pad_center(
        fourier.get_window(window_name, fft_size).astype(np.float64) ** 2, fft_size)
    with audio_io.StreamReader(in_path) as reader, contextlib.ExitStack() as stack:
        sr = reader.sample_rate
        n = int(reader.frames)
        chans = list(channels) if channels is not None else list(range(reader.channels))
        T = (n + pad) // hop + 1  # frames of the centred padded STFT
        out_ch = 1 if mix_down else len(chans)
        writers = [stack.enter_context(audio_io.open_writer(p, sr, out_ch))
                   for p in out_paths]
        # one span shape for every block: the tail block reads the same span
        # (virtual_read reflects past the end) and zeroes its extra frames
        t_span = block_frames + 2 * mask_halo_frames + (fft_size // hop) + 2
        s0 = 0
        while s0 < n:
            s1 = min(n, s0 + block_frames * hop)
            # frames whose windows touch [s0, s1)
            t_lo = max(0, -(-(s0 + pad - fft_size + 1) // hop))
            t_hi = min(T, (s1 - 1 + pad) // hop + 1)
            te_lo = max(0, t_lo - mask_halo_frames)
            te_hi = min(T, t_hi + mask_halo_frames)
            a = te_lo * hop - pad  # span in padded-signal coordinates
            b = (te_lo + t_span - 1) * hop - pad + fft_size
            span = torch.as_tensor(virtual_read(reader, a, b, pad, chans).T, device=dev)
            spec = fourier.stft(span, n_fft=fft_size, step=hop, window_name=window_name,
                                zeropad=zeropad, center=False)
            # frames past te_hi are reflect-padding artifacts: zero them (their
            # overlap-add windows lie past the emitted range anyway)
            spec[..., te_hi - te_lo:] = 0
            facs = make_fac(spec, te_lo)
            if not isinstance(facs, (list, tuple)):
                facs = [facs]
            lo_cut = t_lo - te_lo
            env = None
            for fac, writer in zip(facs, writers):
                sp = (spec * fac)[..., lo_cut:]
                sp[..., t_hi - t_lo:] = 0
                y = fourier.istft_frames_raw(sp, hop, window_name, zeropad)
                if env is None:
                    # the local envelope: the global one's float64 addends in
                    # its order, so the interior division is exact
                    span_len = y.shape[-1]
                    env64 = np.zeros(span_len, np.float64)
                    for t in range(t_lo, t_hi):
                        s = (t - t_lo) * hop
                        env64[s:s + fft_size] += win_sq[:max(0, min(fft_size, span_len - s))]
                    env32 = env64.astype(np.float32)
                    env = torch.as_tensor(np.where(env32 > tiny, env32, np.float32(1.0)),
                                          device=dev)
                y = y / env
                if mix_down:
                    y = y.sum(dim=0, keepdim=True)
                # final[s] lives at overlap-add coordinate s + pad - t_lo*hop
                off = s0 + pad - t_lo * hop
                writer.write(y[:, off:off + (s1 - s0)].T.cpu().numpy())
            if progress is not None:
                progress(int(100 * s1 / n))
            s0 = s1
    return out_path


def iter_blocks(n_samples, hop, blocksize=4096, overlap=32):
    """Yield (lo, hi, start, stop, trim_lo_frames, trim_hi_frames) block
    spans in samples; each block carries an ``overlap*hop`` halo on both
    sides."""
    block = blocksize * hop
    halo = overlap * hop
    trim = overlap // 2
    start = 0
    while start < n_samples:
        stop = min(n_samples, start + block)
        lo = max(0, start - halo)
        hi = min(n_samples, stop + halo)
        trim_lo = (start - lo) // hop
        trim_hi = (hi - stop) // hop
        yield lo, hi, start, stop, min(trim, trim_lo), min(trim, trim_hi)
        start = stop


def stream_trace(signal, sr, tracker, fft_size, hop, blocksize=4096, overlap=32):
    """Run a frame-rate tracker blockwise over a long signal, trimming halo
    frames at the seams.  ``tracker(block, sr) -> (times, values)`` with
    times relative to the block.  Returns concatenated (times, values)."""
    all_times, all_vals = [], []
    for lo, hi, start, stop, trim_lo, trim_hi in iter_blocks(
            len(signal), hop, blocksize, overlap):
        times, vals = tracker(signal[lo:hi], sr)
        n = len(times)
        sl = slice(trim_lo, n - trim_hi if trim_hi else n)
        all_times.append(np.asarray(times)[sl] + lo / sr)
        all_vals.append(np.asarray(vals)[sl])
    return np.concatenate(all_times), np.concatenate(all_vals)


def stream_process(signal, process, hop, blocksize=4096, overlap=32):
    """Blockwise sample-domain processing with halo trim and concatenation
    (streaming.py:208-219).  ``process(block) -> block`` must keep the
    length (e.g. a masked STFT -> iSTFT round trip); a tensor result is
    downloaded.  Returns the processed signal (numpy)."""
    pieces = []
    for lo, hi, start, stop, trim_lo, trim_hi in iter_blocks(
            len(signal), hop, blocksize, overlap):
        out = process(signal[lo:hi])
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        pieces.append(out[start - lo: len(out) - (hi - stop) if hi - stop else len(out)])
    return np.concatenate(pieces)
