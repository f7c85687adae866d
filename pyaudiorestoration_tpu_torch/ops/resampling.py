"""Variable-speed windowed-sinc resampling (counterpart of
pyaudiorestoration_tpu/ops/resampling.py).

Positions are planned on the host in float64 (``speed_to_pos``,
``lag_to_pos``; the reference's error-dithering loop as a rounded cumsum)
and shipped to the device as an exact (int32 anchor, float32 shift) split.

``sinc_resample`` has two branches, chosen as in the JAX package:

* **banded**, when the positions advance near-monotonically (speed curves
  near 1, lag curves): output blocks of ``block`` samples, each with an
  integer input anchor and positions relative to it.  That is kernel K1's
  contract exactly (``kernels/sinc_banded.sinc_banded``): the block anchors
  are its ``base_int``, the per-sample cutoffs its ``bs`` (all <= 1, so its
  ``min(bs, 1)`` leaves them as they are), the relative positions its
  ``rel``, every lane valid, ``max_n = block``.  The hann taper, the window
  rule and the zero outside the signal are the same as the JAX
  ``_sinc_banded_blocks`` (resampling.py:141-172).  On the card this branch
  runs K1, once per channel; on the CPU its plain version.
* **gather**, for large ratios: a tiled gather of the 2*quality taps
  around each position, plain torch ops (XLA code in JAX, not Pallas).

Tap convention: 2*NT taps (j in [-NT, NT)), as the reference's interior
loop; out-of-range taps read zero.
"""

from __future__ import annotations

import functools
import logging
import os

import numpy as np
import torch

from ..kernels.sinc_banded import sinc_banded
from ..utils import audio_io
from ..utils.device import as_device_tensor
from ..utils.timing import Stages, log_duration

__all__ = [
    "speed_to_pos", "lag_to_pos", "sinc_resample", "linear_resample",
    "resample_ratio", "run", "banded_layout",
]

ROWS_PER_LAUNCH = 16384  # output blocks per K1 launch: bounds the grids' memory


def speed_to_pos(sampletimes, speeds, num_input_samples):
    """Convert a speed curve to output-sample positions (host float64).

    ``sampletimes``: sample indices where ``speeds`` is sampled (evenly
    spaced); returns positions into the input signal for every output sample,
    trimmed at the end of the input (resampling.py:93-137).
    """
    sampletimes = np.asarray(sampletimes, dtype=np.float64)
    speeds = np.asarray(speeds, dtype=np.float64)
    periods = np.diff(sampletimes)
    # target output counts per segment before dithering
    n_raw = periods * (speeds[:-1] + speeds[1:]) / 2.0
    # the reference's error-dithering loop == differenced rounded cumsum
    cum = np.cumsum(n_raw)
    n = np.diff(np.round(np.concatenate([[0.0], cum]))).astype(np.int64)
    n = np.maximum(n, 0)
    total = int(n.sum())
    if total <= 0:
        return np.empty(0, dtype=np.float64)
    # per-output-sample segment id and index within the segment
    seg = np.repeat(np.arange(len(n)), n)
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    k = np.arange(total) - starts[seg]
    denom = np.maximum(n[seg] - 1, 1).astype(np.float64)
    block_speeds = k / denom * (speeds[seg + 1] - speeds[seg]) + speeds[seg]
    positions = np.cumsum(1.0 / block_speeds) + sampletimes[0]
    # trim where the input signal ends (nearest position to the end)
    inside = positions <= num_input_samples
    if not inside.all():
        end = int(np.argmin(np.abs(positions - num_input_samples)))
        positions = positions[:end]
    return positions


def lag_to_pos(sampletimes, lags, num_input_samples):
    """Lag curve -> positions (resampling.py:189-206 inline logic)."""
    sampletimes = np.asarray(sampletimes, dtype=np.float64)
    lags = np.asarray(lags, dtype=np.float64)
    num_output_samples = int(num_input_samples + abs(lags[-1]))
    sample_at = np.interp(np.arange(num_output_samples), sampletimes, sampletimes - lags)
    over = np.nonzero(sample_at >= num_input_samples)[0]
    if len(over):
        sample_at = sample_at[:over[0]]
    return np.clip(sample_at, 0, None)


@functools.lru_cache(maxsize=16)
def _sinc_window(nt: int) -> np.ndarray:
    # reference: np.hanning(2*NT+1), of which only the first 2*NT taps are used
    return np.hanning(2 * nt + 1)[: 2 * nt].astype(np.float32)


def _sinc_device(sig, ind, shift, fc, nt: int, tile: int):
    """Tiled gather + windowed-sinc MAC of a 1-D signal; ``ind``/``shift``/
    ``fc`` (padded to a multiple of ``tile``) on its device."""
    n_in = sig.shape[0]
    dev = sig.device
    offs = torch.arange(-nt, nt, dtype=torch.int32, device=dev)[None, :]
    offs_f = offs.to(torch.float32)
    win = torch.as_tensor(_sinc_window(nt), device=dev)[None, :]
    out = []
    for a in range(0, ind.shape[0], tile):
        ind_t, shift_t, fc_t = ind[a:a + tile], shift[a:a + tile], fc[a:a + tile]
        idx = ind_t[:, None] + offs
        valid = (idx >= 0) & (idx < n_in)
        g = sig[torch.clamp(idx, 0, n_in - 1).to(torch.int64)]
        x = (offs_f - shift_t[:, None]) * fc_t[:, None]
        w = torch.sinc(x) * fc_t[:, None] * win
        out.append(torch.sum(torch.where(valid, g * w, 0.0), dim=-1))
    return torch.cat(out)


def _positions_to_device_args(sample_at):
    """Split float64 positions into exact (int32 anchor, float32 shift) + fc."""
    sample_at = np.asarray(sample_at, dtype=np.float64)
    ind = np.round(sample_at).astype(np.int64)
    shift = (sample_at - ind).astype(np.float32)
    period = np.diff(sample_at)
    if len(period):
        period = np.concatenate([period, period[-1:]])  # last fc reuses previous period
    else:
        period = np.ones(len(sample_at))
    fc = np.minimum(1.0 / np.maximum(period, 1e-12), 1.0).astype(np.float32)
    return ind.astype(np.int32), shift, fc


def banded_layout(sample_at, fc, block: int = 512, max_band_drift: int = 192):
    """Host: the banded branch's inputs for float64 positions, or None when
    an in-block excursion exceeds ``max_band_drift`` (the gather branch's
    case).  Returns (anchors (R,) int32, rel (R, block) float32, fc
    (R, block) float32, drift bucket), R = ceil(n_out / block); the padded
    tail repeats the last position with cutoff 1 (resampling.py:211-225).

    The excursion is measured over the real outputs only.  The JAX package
    measures it over the padded tail too, where the repeated last position
    falls ``block - (n_out % block)`` lanes behind its index: a take whose
    last block is under ``block - max_band_drift`` samples long therefore
    takes its gather branch whatever its speed curve.  The padded lanes'
    outputs are dropped, and the kernel counts a tap only inside its
    window whatever the excursion, so the real outputs do not depend on
    that choice."""
    n_out = len(sample_at)
    n_blocks = -(-n_out // block)
    grid_pad = n_blocks * block - n_out
    pos_b = np.pad(sample_at, (0, grid_pad), mode="edge").reshape(n_blocks, block)
    anchors = np.round(pos_b[:, 0]).astype(np.int64)
    rel = pos_b - anchors[:, None]
    excursion = np.abs(np.round(rel) - np.arange(block)[None, :]).reshape(-1)[:n_out]
    drift_needed = int(np.ceil(excursion.max())) + 1
    if drift_needed > max_band_drift:
        return None
    drift = 8
    while drift < drift_needed:
        drift *= 2
    fc_b = np.pad(fc, (0, grid_pad), constant_values=1.0).reshape(n_blocks, block)
    return anchors.astype(np.int32), rel.astype(np.float32), fc_b, drift


def _sinc_banded_blocks(sig, anchors, rel, fc, nt: int, drift: int):
    """Banded sinc over fixed-size output blocks of a 1-D signal: K1 with
    ``base_int = anchors``, ``bs = fc``, ``rel``, every lane valid and
    ``max_n`` the block length, ``ROWS_PER_LAUNCH`` blocks a launch.
    Returns (R, block)."""
    rows = ROWS_PER_LAUNCH
    return torch.cat([
        sinc_banded(sig, anchors[a:a + rows], fc[a:a + rows], rel[a:a + rows],
                    torch.ones(rel[a:a + rows].shape, dtype=torch.bool,
                               device=rel.device), nt, drift)
        for a in range(0, rel.shape[0], rows)])


def sinc_resample(signal, sample_at, quality: int = 50, tile: int = 16384,
                  block: int = 512, max_band_drift: int = 192,
                  device_out: bool = False, device="cuda", timings=None):
    """Windowed-sinc resample of a (time,) or (time, channels) signal at
    float64 positions.  ``quality`` is the reference's ``sinc_quality`` NT
    (resampling.py:21-27).  Returns float32 of len(sample_at) (and the
    channels): numpy, or with ``device_out=True`` a tensor left on the
    device.  ``signal``: a tensor (which keeps its device) or a host array
    (uploaded to ``device``).  See the module docstring for the branches.
    ``timings``, a dict, receives the seconds of the upload, the host
    positions and their layout, the sinc and the download
    (``utils.timing.Stages``)."""
    n_out = len(sample_at)
    stages = Stages(timings,
                    signal.device if isinstance(signal, torch.Tensor) else device)
    sig = as_device_tensor(signal, device, torch.float32)
    stages.mark("upload")
    was_1d = sig.dim() == 1
    if was_1d:
        sig = sig[:, None]
    if n_out == 0:
        out = np.empty((0, sig.shape[1]), np.float32)
        return out[:, 0] if was_1d else out
    dev = sig.device
    sample_at = np.asarray(sample_at, dtype=np.float64)
    # exact (anchor, shift) split + per-sample cutoff from the *unpadded*
    # positions, the last period reused (reference convention, resampling.py:71)
    ind, shift, fc = _positions_to_device_args(sample_at)
    layout = banded_layout(sample_at, fc, block, max_band_drift)
    if layout is not None:
        anchors, rel, fc_b, drift = layout
        anchors, rel, fc_b = (torch.as_tensor(v, device=dev) for v in (anchors, rel, fc_b))
        stages.mark("positions")
        out = torch.stack([_sinc_banded_blocks(sig[:, c].contiguous(), anchors, rel,
                                               fc_b, int(quality), drift).reshape(-1)
                           for c in range(sig.shape[1])], dim=-1)[:n_out]
    else:
        pad = (-n_out) % tile
        args = [torch.as_tensor(np.pad(v, (0, pad), constant_values=c), device=dev)
                for v, c in ((ind, 0), (shift, 0), (fc, 1.0))]
        stages.mark("positions")
        out = torch.stack([_sinc_device(sig[:, c], *args, int(quality), int(tile))
                           for c in range(sig.shape[1])], dim=-1)[:n_out]
    stages.mark("sinc")
    if not device_out:
        out = out.cpu().numpy()
        stages.mark("download")
    return out[:, 0] if was_1d else out


def _linear_device(sig, ind, frac):
    n_in = sig.shape[0]
    lo = torch.clamp(ind, 0, n_in - 1).to(torch.int64)
    hi = torch.clamp(ind + 1, 0, n_in - 1).to(torch.int64)
    # reference uses np.interp(..., left=0, right=0)
    inside = (ind >= 0) & (ind <= n_in - 1)
    exact_end = (ind == n_in - 1) & (frac == 0)
    keep = inside & ((ind < n_in - 1) | exact_end)
    if sig.dim() > 1:
        frac, keep = frac[:, None], keep[:, None]
    out = sig[lo] * (1.0 - frac) + sig[hi] * frac
    return torch.where(keep, out, 0.0)


def linear_resample(signal, sample_at, device="cuda"):
    """Linear-interpolation resampling, matching np.interp(left=0, right=0).
    ``signal`` may be (time,) or (time, channels); returns numpy float32."""
    sample_at = np.asarray(sample_at, dtype=np.float64)
    ind = np.floor(sample_at).astype(np.int64)
    frac = (sample_at - ind).astype(np.float32)
    sig = as_device_tensor(signal, device, torch.float32)
    dev = sig.device
    out = _linear_device(sig, torch.as_tensor(ind.astype(np.int32), device=dev),
                         torch.as_tensor(frac, device=dev))
    return out.cpu().numpy()


def resample_ratio(signal, sr_from, sr_to, quality: int = 16, axis: int = 0,
                   device_out: bool = False, device="cuda", timings=None):
    """Constant-ratio resampler (replaces resampy.resample usages); 1-D or
    2-D ``signal`` with time on ``axis``.  ``device_out=True`` keeps the
    result on the device, and ``timings`` receives its stages (see
    :func:`sinc_resample`)."""
    ratio = float(sr_from) / float(sr_to)
    n_out = int(round(signal.shape[axis] / ratio))
    sample_at = np.arange(n_out, dtype=np.float64) * ratio
    if signal.ndim == 1:
        return sinc_resample(signal, sample_at, quality=quality,
                             device_out=device_out, device=device, timings=timings)
    if isinstance(signal, torch.Tensor):
        moved = torch.movedim(signal, axis, 0)
    else:
        moved = np.moveaxis(np.asarray(signal), axis, 0)
    out = sinc_resample(moved, sample_at, quality=quality, device_out=device_out,
                        device=device, timings=timings)
    return torch.movedim(out, 0, axis) if device_out else np.moveaxis(out, 0, axis)


def run(filenames, signal_data=None, speed_curve=None, resampling_mode="Linear",
        sinc_quality=50, use_channels=(), prog_sig=None, lag_curve=None, suffix="",
        device="cuda"):
    """Batch resampling entry mirroring the reference's ``run`` contract
    (resampling.py:162-240): writes ``<name>_res<suffix>.<ext>`` per input
    (extension from :func:`audio_io.set_output_format`, default wav).
    Returns the list of output paths."""
    def progress(pct):
        # prog_sig mirrors the reference's notifyProgress signal contract
        # (resampling.py:165-168); plain callables are accepted too
        if prog_sig is None:
            return
        emit = getattr(getattr(prog_sig, "notifyProgress", None), "emit", None)
        (emit or prog_sig)(pct)

    progress(0)
    out_paths = []
    if signal_data is None:
        signal_data = [None for _ in filenames]
    for filename, sig_data in zip(filenames, signal_data):
        with log_duration("Preparing"):
            logging.info(f"Resampling '{os.path.basename(filename)}'... "
                         f"{resampling_mode}, {sinc_quality}, {use_channels}")
            if sig_data:
                signal, sr = sig_data
                num_channels = signal.shape[1]
            else:
                signal, sr, num_channels = audio_io.read_file(filename)
            if speed_curve is not None:
                sampletimes = np.asarray(speed_curve)[:, 0] * sr
                speeds = np.asarray(speed_curve)[:, 1]
                sample_at = speed_to_pos(sampletimes, speeds, len(signal))
            elif lag_curve is not None:
                sampletimes = np.asarray(lag_curve)[:, 0] * sr
                lags = np.asarray(lag_curve)[:, 1] * sr
                sample_at = lag_to_pos(sampletimes, lags, len(signal))
            else:
                raise ValueError("need speed_curve or lag_curve")
        channels = [c for c in use_channels if c < signal.shape[1]] or list(range(num_channels))
        fi = len(out_paths)
        n_files = len(filenames)
        progress(int((fi + 0.25) / n_files * 100))
        with log_duration("Resampling"):
            sel = np.ascontiguousarray(signal[:, channels])
            if resampling_mode == "Sinc":
                output = sinc_resample(sel, sample_at, quality=sinc_quality,
                                       device=device)
            else:
                output = linear_resample(sel, sample_at, device=device)
            progress(int((fi + 0.85) / n_files * 100))
        with log_duration("Writing"):
            out_path = audio_io.write_file(filename, np.asarray(output), sr,
                                           suffix=f"_res{suffix}")
            out_paths.append(out_path)
            progress(int(len(out_paths) / n_files * 100))
    logging.info("Done!")
    return out_paths
