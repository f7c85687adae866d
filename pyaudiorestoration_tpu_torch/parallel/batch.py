"""Batch restoration over the ``files`` mesh axis (counterpart of
pyaudiorestoration_tpu/parallel/batch.py).

A batch of recordings spreads over the ranks of a ('files', 'time') mesh:
the files axis carries the takes (or the channels of one take), the time
axis shards each recording (``parallel.sharded``).  The file-level entries
start their own world (``mesh.launch``: one rank per visible card, one on
the CPU, ``n_ranks`` to choose) or, under ``torchrun``, join its group.
Rank 0 reads each group of files once and sends every rank its block, and
gathers the results to write them.  Every take's output is bit-identical to
its solo ``restore_fused_device`` run, whatever the grouping or the mesh.

A rank of the fused batch holds several takes of a group at once (all
in one sinc launch): one rank takes ``min(len(paths), 8)`` by default, as
many as keep its flattened signal under the int32 cap of the sinc's
anchors.  A take of 2**31 samples or more raises the world until its time
shards are under 2**30 samples (ranks may then share a card); the plan
carries its global positions in int64.  The host helpers are copies of the
JAX package's, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..utils import audio_io, streaming
from . import sharded
from .mesh import (Mesh, gather_time_batch, in_world, run_in_world, shard_time_batch,
                   world_ranks)

__all__ = ["load_batch", "reflect_continue", "validate_plan", "restore_batch",
           "restore_batch_files", "restore_batch_files_fused", "restore_file_sharded",
           "lag_resample_file_sharded"]

_SHARD_CAP = 1 << 30  # samples a rank holds on the mesh path


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


def restore_batch(mesh: Mesh, batch, f0_hz, sr, src: int | None = 0, **kwargs):
    """The fixed-length restore step (``sharded.restore_step``, keywords
    passed on) over an already-built (files, time) host batch, held by rank
    ``src`` (None: by every rank).  Returns the restored batch as a numpy
    array on rank 0, None on the others."""
    xs = shard_time_batch(mesh, batch, src=src)
    return gather_time_batch(mesh, sharded.restore_step(mesh, xs, f0_hz, sr, **kwargs))


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


def _broadcast(obj):
    """Rank 0's small host ``obj`` on every rank of the world."""
    if not _in_group():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _mesh_shape(world: int, n_files: int, n_files_axis=None, min_time: int = 1):
    """(files, time) factorization of a world: ``n_files_axis`` (default the
    batch's file count, at most the world), lowered until it divides the
    world and leaves at least ``min_time`` time shards."""
    nf = max(1, min(n_files_axis or n_files, world))
    while world % nf or world // nf < min_time:
        nf -= 1
    return nf, world // nf


def _world_size(default_ranks: int, samples: int) -> int:
    """Ranks of a world that spreads ``samples`` (a take's row, or all its
    channels) so that no rank holds ``_SHARD_CAP`` or more: at least
    ``default_ranks``."""
    return max(default_ranks, -(-samples // _SHARD_CAP))


def _takes_per_rank(want: int, row_samples: int) -> int:
    """Takes a rank holds in one call: ``want``, lowered until their
    flattened signal (``row_samples`` each, ``sharded.flat_row_samples``)
    stays under the int32 cap of the sinc's anchors; at least one."""
    return max(1, min(want, (sharded.FLAT_CAP - 1) // row_samples))


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def restore_batch_files_fused(paths, f0_hz=None, tolerance_st: float = 1.0,
                              fft_size: int = 4096, fft_overlap: int = 8,
                              zeropad: int = 2, sinc_quality: int = 50,
                              drift: int = 32, n_files_axis=None,
                              out_suffix="_res", backend: str = "auto",
                              device="cuda", n_ranks=None):
    """End-to-end fused batch restore of independent takes over the mesh
    (``sharded.restore_fused_sharded``): read the files (channel 0) ->
    track, plan and resample each take -> validate each take's plan -> host
    compaction -> write mono ``*_res`` files.  Returns the output paths (on
    rank 0 of a world; [] on the others).

    Each file tracks its own speed curve, and its output is bit-identical to
    its solo restore whatever the grouping or the mesh.  ``n_ranks``
    (default: one per visible card, one on the CPU) sets the world; a take
    of 2**31 samples or more raises it until every time shard is under
    2**30 samples.  ``n_files_axis``: takes a group (default ``min(len(paths),
    8)``), spread over the files axis (as many ranks as divide the world)
    and held several to a rank where the axis is shorter, as many as keep a
    rank's flattened signal under 2**31 samples.  ``f0_hz=None`` probes the
    pilot tone from the first file."""
    step = fft_size // fft_overlap
    # decoded samples over all channels bound each take's length from the
    # header, before anything is read
    rows = [-(-(streaming.decoded_bytes(p) // 4 + fft_size) // step) * step
            for p in paths]
    if not in_world():
        n_ranks = _world_size(n_ranks or world_ranks(device), max(rows))
    return run_in_world(_fused_mesh_rank, n_ranks, (
        max(rows), paths, f0_hz, tolerance_st, fft_size, fft_overlap, zeropad,
        sinc_quality, drift, n_files_axis, out_suffix, backend), device)


def _write_takes(paths, lengths, padded, nn, bi, bf, step, slack, sr, out_suffix):
    """Validate each take's plan, compact its first ``length // step``
    segments (its solo run's) and write it; returns the output paths."""
    out = []
    for j, (path, length) in enumerate(zip(paths, lengths)):
        t_real = min(nn.shape[1], length // step)
        validate_plan(bi[j], bf[j], step, t_real, slack)
        flat = sharded.compact_padded_host(padded[j, :t_real], nn[j, :t_real])
        out.append(audio_io.write_file(path, flat, sr, 1, suffix=out_suffix))
    return out


def _fused_mesh_rank(dev, max_row, paths, f0_hz, tolerance_st, fft_size, fft_overlap,
                     zeropad, sinc_quality, drift, n_files_axis, out_suffix, backend):
    """One rank of :func:`restore_batch_files_fused` (JAX batch.py:106-167):
    groups of ``n_files_axis`` takes, ``k`` rows a rank, the last group
    padded with its own last file to a multiple of the files axis; rank 0
    reads each group once, sends the blocks and writes the outputs."""
    from ..pipelines.respeeder_device import _band_limits, _probe_f0

    step = fft_size // fft_overlap
    max_n, nt = int(step * 1.25), int(sinc_quality)
    world = dist.get_world_size()
    per_group = n_files_axis or min(len(paths), 8)
    nf, nt_ = _mesh_shape(world, len(paths), per_group,
                          min_time=-(-max_row // _SHARD_CAP))
    mesh = Mesh(nf, nt_, dev)
    shard = -(-max_row // (nt_ * step)) * step  # the longest group's shard
    k = _takes_per_rank(-(-per_group // nf),
                        sharded.flat_row_samples(shard, step, max_n, nt, drift))
    slack = nt + drift + 16 + 2  # nt + drift + base_slack
    out_paths = []
    for i in range(0, len(paths), nf * k):
        group = paths[i:i + nf * k]
        rows_a_rank = -(-len(group) // nf)
        pad_group = list(group) + [group[-1]] * (nf * rows_a_rank - len(group))
        batch = meta = None
        if mesh.rank == 0:
            batch, sr, lengths = load_batch(pad_group, multiple=nt_ * step,
                                            reflect_tail=fft_size)
            if f0_hz is None:
                f0_hz = _probe_f0(batch[0], sr)
            meta = (batch.shape[1], sr, lengths, f0_hz)
        n, sr, lengths, f0_hz = _broadcast(meta)
        NLv, NUv = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
        F = n // step + 1
        xs = shard_time_batch(mesh, batch, src=0)
        out = sharded.restore_fused_sharded(
            mesh, xs, np.full(F, NLv, np.int32), np.full(F, NUv, np.int32), fft_size,
            step, zeropad, max_n=max_n, nt=nt, drift=drift, backend=backend,
            lengths=lengths)
        padded, nn, bi, bf = (gather_time_batch(mesh, t) for t in out)
        if mesh.rank == 0:
            out_paths += _write_takes(group, lengths, padded, nn, bi, bf, step, slack,
                                      sr, out_suffix)
    return out_paths


def _read_channels(dev, path, multiple_of_step: int, probe: bool = False):
    """Rank 0 reads ``path``; every rank builds the mesh with the channels
    on its files axis (as many as the world allows) and gets its block of
    the zero-padded (channels, n) batch, n a multiple of the time shards
    times ``multiple_of_step``.  Returns (mesh, block, length, sr, channels,
    the pilot tone probed from channel 0 if ``probe``, else None)."""
    from ..pipelines.respeeder_device import _probe_f0

    sig = meta = None
    if not _in_group() or dist.get_rank() == 0:
        sig, sr, C = audio_io.read_file(path)
        meta = (sig.shape[0], sr, C)
    length, sr, C = _broadcast(meta)
    world = dist.get_world_size() if _in_group() else 1
    mesh = Mesh(*_mesh_shape(world, C), dev)
    batch = f0 = None
    if sig is not None:
        nf = mesh.shape["files"]
        mult = mesh.shape["time"] * multiple_of_step
        batch = np.zeros((-(-C // nf) * nf, -(-length // mult) * mult), np.float32)
        batch[:C, :length] = sig.T
        f0 = _probe_f0(batch[0], sr) if probe else None
    return mesh, shard_time_batch(mesh, batch, src=0), length, sr, C, _broadcast(f0)


def restore_file_sharded(path, f0_hz=None, tolerance_st: float = 1.0,
                         fft_size: int = 4096, fft_overlap: int = 8,
                         zeropad: int = 2, sinc_quality: int = 50,
                         drift: int = 32, out_suffix="_res",
                         backend: str = "auto", device="cuda", n_ranks=None):
    """ALL channels of one recording through the mesh's fused restore with
    the reference's shared-curve export contract (resampling.py:211-231):
    the channels ride the files axis, every one resamples through channel
    0's tracked curve, and the time axis shards the recording.  Writes one
    multi-channel ``*_res`` file; returns its path (None on ranks other
    than 0).  The world (default: one rank per visible card, one on the CPU)
    grows until no rank holds 2**30 samples of the padded channels, so that
    a rank's flattened signal stays under the int32 cap of the sinc."""
    if not in_world():
        # a rank holds (padded channels / files axis) x (padded length / time
        # axis) samples: under twice the take's decoded samples over the world
        n_ranks = _world_size(n_ranks or world_ranks(device),
                              2 * (streaming.decoded_bytes(path) // 4))
    return run_in_world(_file_sharded_rank, n_ranks, (
        path, f0_hz, tolerance_st, fft_size, fft_overlap, zeropad, sinc_quality, drift,
        out_suffix, backend), device)


def _file_sharded_rank(dev, path, f0_hz, tolerance_st, fft_size, fft_overlap, zeropad,
                       sinc_quality, drift, out_suffix, backend):
    from ..pipelines.respeeder_device import _band_limits

    step = fft_size // fft_overlap
    mesh, xs, length, sr, C, f0 = _read_channels(dev, path, step, f0_hz is None)
    f0_hz = f0 if f0_hz is None else f0_hz
    n = xs.shape[1] * mesh.shape["time"]
    NLv, NUv = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
    F = n // step + 1
    out = sharded.restore_fused_sharded(
        mesh, xs, np.full(F, NLv, np.int32), np.full(F, NUv, np.int32), fft_size, step,
        zeropad, max_n=int(step * 1.25), nt=int(sinc_quality), drift=drift,
        backend=backend, share_curve=True)
    padded, nn, bi, bf = (gather_time_batch(mesh, t) for t in out)
    if mesh.rank != 0:
        return None
    counts = nn[0]
    t_real = min(len(counts), -(-length // step))
    validate_plan(bi[0], bf[0], step, t_real, int(sinc_quality) + drift + 16 + 2)
    y = np.stack([sharded.compact_padded_host(padded[c][:t_real], counts[:t_real])
                  for c in range(C)], axis=-1)
    return audio_io.write_file(path, y, sr, C, suffix=out_suffix)


def lag_resample_file_sharded(path, sampletimes_s, lags_s, hop: int = 256,
                              sinc_quality: int = 50, drift: int = 32,
                              out_suffix="_res", device="cuda", n_ranks=None):
    """The tapesynch export on the mesh: ALL channels of ``path`` through
    one lag curve (seconds), the channels on the files axis and the
    recording sharded along time (``sharded.lag_resample_sharded``).
    Fixed-length output (samples past the input end read zeros).  Writes
    one multi-channel ``*_res`` file; reference semantics
    pytapesynch_gui.py:145-155 / resampling.py:189-206."""
    return run_in_world(_lag_file_rank, n_ranks, (
        path, sampletimes_s, lags_s, hop, sinc_quality, drift, out_suffix), device)


def _lag_file_rank(dev, path, sampletimes_s, lags_s, hop, sinc_quality, drift,
                   out_suffix):
    mesh, xs, length, sr, C, _ = _read_channels(dev, path, hop)
    st = np.asarray(sampletimes_s, np.float64) * sr
    lg = np.asarray(lags_s, np.float64) * sr
    out = gather_time_batch(mesh, sharded.lag_resample_sharded(
        mesh, xs, st, lg, hop=hop, nt=int(sinc_quality), drift=drift))
    if mesh.rank != 0:
        return None
    return audio_io.write_file(path, out[:C, :length].T, sr, C, suffix=out_suffix)


def restore_batch_files(paths, f0_hz, n_files_axis=None, out_suffix="_res",
                        device="cuda", n_ranks=None, **kwargs):
    """End-to-end fixed-length tier (``respeed-batch --tier fixed``): read
    the files (channel 0) -> mesh -> ``sharded.restore_step`` (keywords
    passed on: ``n_fft``, ``step``, ``interp``, ...) -> write mono
    ``*_res`` files of the input lengths.  Returns the output paths (on
    rank 0)."""
    return run_in_world(_fixed_files_rank, n_ranks, (
        paths, f0_hz, n_files_axis, out_suffix, kwargs), device)


def _fixed_files_rank(dev, paths, f0_hz, n_files_axis, out_suffix, kwargs):
    world = dist.get_world_size() if _in_group() else 1
    nf, nt_ = _mesh_shape(world, len(paths), n_files_axis)
    mesh = Mesh(nf, nt_, dev)
    step = kwargs.get("step", 128)
    out_paths = []
    for i in range(0, len(paths), nf):
        group = paths[i:i + nf]
        pad_group = list(group) + [group[-1]] * (nf - len(group))
        batch = meta = None
        if mesh.rank == 0:
            batch, sr, lengths = load_batch(pad_group, multiple=nt_ * step)
            meta = (sr, lengths)
        sr, lengths = _broadcast(meta)
        out = restore_batch(mesh, batch, f0_hz, sr, src=0, lengths=lengths, **kwargs)
        if mesh.rank == 0:
            for path, row, length in zip(group, out, lengths):
                out_paths.append(audio_io.write_file(path, row[:length], sr, 1,
                                                     suffix=out_suffix))
    return out_paths
