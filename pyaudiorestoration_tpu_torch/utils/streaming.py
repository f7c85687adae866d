"""Host helpers of the port's larger-than-memory paths (the parts of
``pyaudiorestoration_tpu/utils/streaming.py`` that the port calls): the
auto-stream threshold on the decoded size, and the blockwise tracker with
halo trim of the reference tool (experiments/pyrespeeder_cmd.py:16-49)."""

from __future__ import annotations

import numpy as np

from . import audio_io

__all__ = ["decoded_bytes", "should_stream", "iter_blocks", "stream_trace"]


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
