"""Batch restoration of independent takes on one card (counterpart of
pyaudiorestoration_tpu/parallel/batch.py).

The JAX package spreads a batch over a ('files', 'time') device mesh
(``restore_fused_sharded``); every take's output there is bit-identical to
its solo ``restore_fused_device`` run, whatever the grouping.  On one card
no mesh is needed: a group of files goes through ``restore_fused_takes``
with per-take ``lengths``, which keeps that contract.  The host helpers are
copied bit for bit.
"""

from __future__ import annotations

import numpy as np

from ..utils import audio_io, streaming
from ..utils.device import resolve_device
from . import sharded

__all__ = ["load_batch", "reflect_continue", "validate_plan",
           "restore_batch_files_fused"]

_INT32_CAP = 1 << 31


def load_batch(paths, multiple: int = 1, channel: int = 0,
               reflect_tail: int = 0):
    """Read files into a zero-padded (files, time) batch.

    All files must share a sample rate; lengths pad to the maximum plus
    ``reflect_tail``, rounded up to ``multiple``.  ``reflect_tail``:
    continue each row past its real end with the take's reflection for this
    many samples (zeros after), the solo path's boundary convention.
    Returns (batch, sr, lengths)."""
    signals, srs = [], []
    for p in paths:
        sig, sr, _ = audio_io.read_file(p)
        signals.append(sig[:, channel])
        srs.append(sr)
    if len(set(srs)) != 1:
        raise ValueError(f"Sample rates differ: {srs}")
    lengths = [len(s) for s in signals]
    n = max(lengths) + reflect_tail
    n = -(-n // multiple) * multiple
    batch = np.zeros((len(signals), n), dtype=np.float32)
    for i, s in enumerate(signals):
        batch[i, :len(s)] = s
        reflect_continue(batch[i], len(s), reflect_tail)
    return batch, srs[0], lengths


def reflect_continue(row, L, tail):
    """Continue ``row`` past its real end ``L`` with the take's clamped
    single reflection for up to ``tail`` samples, in place: the host twin of
    the device reflection in ``restore_fused_takes``.  Tails longer than the
    take clamp at sample 0."""
    k = min(len(row) - L, tail)
    if k <= 0 or L < 1:
        return row
    idx = np.clip(2 * (L - 1) - (L + np.arange(k)), 0, L - 1)
    row[L:L + k] = row[idx]
    return row


def validate_plan(base_int, base_frac, step: int, t_real: int,
                  slack: int, wrap_bits: int = 32):
    """Unwrap one take's (possibly mod-``2**wrap_bits`` wrapped) plan anchors
    and check the advance invariant before compaction: the dithered plan
    puts segment t's window start within ``slack`` of ``t*step``, which a
    carry or dither bug would break while still giving a plausibly-shaped
    output.  Reference anchor: the float64 planner, resampling.py:93-137."""
    pos = sharded.unwrap_base_int(base_int[:t_real], base_frac[:t_real],
                                  bits=wrap_bits)
    want = np.arange(t_real, dtype=np.float64) * step
    err = np.abs(pos - want)
    if err.size and err.max() > slack:
        t_bad = int(err.argmax())
        raise RuntimeError(
            f"sharded plan violates the one-hop advance invariant at segment "
            f"{t_bad}: window start {pos[t_bad]:.1f} vs expected "
            f"~{want[t_bad]:.0f} (|err| {err.max():.1f} > slack {slack}); "
            f"refusing to write a corrupt export")
    return pos


def _groups(row_bounds, per_group: int):
    """Consecutive groups of at most ``per_group`` file indices whose
    flattened signal (rows of the group's longest length) stays under the
    int32 sample cap.  A single row at the cap raises."""
    groups, cur = [], []
    for i, r in enumerate(row_bounds):
        if r >= _INT32_CAP:
            raise NotImplementedError(
                "a take of 2**31 samples or more: the JAX package wraps its "
                "sharded plan's int32 anchors and unwraps them on the host "
                "(restore_fused_sharded), which the PyTorch port does not "
                "have yet; restore such a take alone with respeed --stream")
        if cur and (len(cur) == per_group
                    or (len(cur) + 1) * max(r, *(row_bounds[j] for j in cur))
                    >= _INT32_CAP):
            groups.append(cur)
            cur = []
        cur.append(i)
    if cur:
        groups.append(cur)
    return groups


def restore_batch_files_fused(paths, f0_hz=None, tolerance_st: float = 1.0,
                              fft_size: int = 4096, fft_overlap: int = 8,
                              zeropad: int = 2, sinc_quality: int = 50,
                              drift: int = 32, n_files_axis=None,
                              out_suffix="_res", backend: str = "auto",
                              device="cuda"):
    """File-level batch restore of independent takes on one card: read the
    files (channel 0) -> ``restore_fused_takes`` per group of
    ``n_files_axis`` files -> validate each take's plan -> host compaction
    -> write mono ``*_res`` files.  Returns the output paths.

    Each file tracks its own speed curve, and its output is bit-identical to
    its solo restore whatever the grouping.  ``n_files_axis`` (files per
    dispatch) defaults to ``min(len(paths), 8)``; a group whose flattened
    signal would reach 2**31 samples is split, and a take that alone would
    reach it raises ``NotImplementedError``: the JAX package never streams a
    batch, it wraps the sharded plan's anchors past 2**31 and unwraps them on
    the host, and that mesh tier is not ported yet.  ``f0_hz=None`` probes
    the pilot tone from the first file."""
    from ..pipelines.respeeder_device import (_band_limits, _probe_f0,
                                              _restore_fused_takes)

    dev = resolve_device(device)
    step = fft_size // fft_overlap
    max_n = int(step * 1.25)
    nt = int(sinc_quality)
    guard = max_n + 2 * (nt + drift)  # _flatten_takes' zero guard per row
    slack = nt + drift + 16 + 2       # nt + drift + the JAX tier's base slack
    # decoded samples over all channels bound each take's length from the
    # header, before anything is read
    rows = [-(-(streaming.decoded_bytes(p) // 4 + fft_size) // step) * step + guard
            for p in paths]
    out_paths = []
    for group in _groups(rows, n_files_axis or min(len(paths), 8)):
        files = [paths[i] for i in group]
        batch, sr, lengths = load_batch(files, multiple=step, reflect_tail=fft_size)
        if f0_hz is None:
            f0_hz = _probe_f0(batch[0], sr)
        NLv, NUv = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
        shape = (len(files), batch.shape[1] // step + 1)
        padded, nn, bi, bf = (t.cpu().numpy() for t in _restore_fused_takes(
            batch, np.full(shape, NLv, np.int32), np.full(shape, NUv, np.int32),
            fft_size, step, zeropad, max_n, nt, drift, "blackmanharris", backend,
            (NLv - 1, NUv + 1), lengths, dev))
        for j, (path, length) in enumerate(zip(files, lengths)):
            t_real = min(nn.shape[1], length // step)  # the solo segment count
            validate_plan(bi[j], bf[j], step, t_real, slack)
            flat = sharded.compact_padded_host(padded[j, :t_real], nn[j, :t_real])
            out_paths.append(audio_io.write_file(path, flat, sr, 1,
                                                 suffix=out_suffix))
    return out_paths
