"""The mesh tier: time-sharded STFT, iSTFT, tool shards and restoration
steps over a :class:`~.mesh.Mesh` (counterpart of
pyaudiorestoration_tpu/parallel/sharded.py).

Every function runs on every rank at once (SPMD), on the rank's own
(files, time) block (``mesh.shard_time_batch``), and returns the rank's
block of the result.  The couplings between shards are the mesh's
collectives:

* STFT: a frame straddling a shard boundary needs ``n_fft - step`` samples
  of the right neighbour (one halo);
* iSTFT overlap-add: a shard's trailing ``n_fft - step`` samples belong to
  the right neighbour's head (one halo, then an add);
* the varispeed resamplers read a bounded drift halo from each neighbour;
* the exact speed centring is a ``psum`` of integer limbs, and the dither
  and position cumsums are shard-local exact (int, frac) prefixes plus an
  ``all_gather`` carry.

Every stage calls the port's dense helpers (``banded_refined_chunk``,
``quantized_log_sums``, ``exact_log_center``, ``segment_advances``,
``_split_cumsum_exclusive``, the sinc kernels), so the two tiers cannot
drift: the fused restore on any mesh is bit-equal to the dense one.

Not ported, as JAX code that exists for XLA alone: ``_mesh_key`` /
``_cached_exec`` (a cache of traced and compiled ``shard_map`` programs;
PyTorch runs eagerly and traces nothing) and the plan's
``jax.lax.optimization_barrier`` (which keeps XLA from fusing the plan
differently from the dense program; PyTorch fuses nothing).

The global integer limb of the dither and position cumsums is int64, so
the plan is exact past 2**31 samples without the JAX tier's wrapping;
``wrap_bits`` < 32 still wraps the RETURNED ``base_int``, as JAX's test
hook does, so that :func:`unwrap_base_int` and ``batch.validate_plan``
stay tested on small inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.sinc_banded import sinc_banded_gathered
from ..ops.fourier import get_window
from .mesh import Mesh

__all__ = ["stft_sharded", "istft_sharded", "restore_step", "halo_exchange_right",
           "hpss_sharded", "cog_sharded", "renoise_sharded", "heal_sharded",
           "restore_fused_sharded", "fused_sharded_plan", "compact_padded_host",
           "unwrap_base_int", "wrap_base_int", "adaptive_peak_sharded",
           "lag_resample_sharded", "lag_windows", "step_positions", "step_halo",
           "step_windows", "flat_row_samples"]


def halo_exchange_right(mesh: Mesh, local, halo: int, axis: str = "time"):
    """Append the right neighbour's first ``halo`` samples along the last
    axis (zeros on the last shard)."""
    recv = mesh.left_ppermute(local[..., :halo], axis)
    return torch.cat([local, recv], dim=-1)


def _stft_local(x_ext, n_fft: int, step: int, window, zeropad: int, n_frames: int):
    """Left-aligned frames t*step of ``x_ext`` (zero past its end) ->
    (..., F, n_frames) spectrum with the reference's 1/sqrt(n_fft) scale."""
    need = (n_frames - 1) * step + n_fft
    xb = F.pad(x_ext, (0, max(0, need - x_ext.shape[-1])))
    frames = xb.unfold(-1, n_fft, step)[..., :n_frames, :] * window
    spec = torch.fft.rfft(frames, n=n_fft * zeropad, dim=-1)
    return spec.transpose(-1, -2) / math.sqrt(n_fft)


def stft_sharded(mesh: Mesh, x, n_fft: int = 1024, step: int = 256,
                 window_name: str = "blackmanharris", zeropad: int = 1):
    """STFT of the rank's (files, local) block: left-aligned frames
    (center=False), global frame t covering samples [t*step, t*step + n_fft).
    Returns the rank's (files, n_freqs, local // step) block.  Requires
    local % step == 0."""
    local = x.shape[-1]
    if local % step:
        raise ValueError("local shard length must be a multiple of step")
    window = torch.as_tensor(get_window(window_name, n_fft), device=x.device)
    ext = halo_exchange_right(mesh, x, n_fft - step)
    return _stft_local(ext, n_fft, step, window, zeropad, local // step)


def _wss_period(window_name: str, n_fft: int, step: int):
    """The interior window-sumsquare envelope over one hop (float32)."""
    window = np.asarray(get_window(window_name, n_fft), dtype=np.float64)
    wss = np.zeros(step)
    for k in range(n_fft // step + 2):
        seg = window[k * step:(k + 1) * step] ** 2
        wss[:len(seg)] += seg
    return np.maximum(wss, np.finfo(np.float32).tiny).astype(np.float32)


def istft_sharded(mesh: Mesh, spec, n_fft: int = 1024, step: int = 256,
                  window_name: str = "blackmanharris"):
    """Inverse of :func:`stft_sharded` (least-squares overlap-add, periodic
    interior normalisation).  ``spec``: the rank's (files, F, T_local)
    block; returns its (files, T_local * step) samples.  The trailing
    ``n_fft - step`` samples of each shard go to the right neighbour and are
    added to its head."""
    if n_fft % step:
        raise ValueError("sharded iSTFT requires hop | n_fft")
    ratio, halo = n_fft // step, n_fft - step
    window = torch.as_tensor(get_window(window_name, n_fft), device=spec.device)
    ytmp = torch.fft.irfft(spec * math.sqrt(n_fft), n=n_fft, dim=-2)
    ytmp = ytmp.transpose(-1, -2) * window  # (B, T, n_fft)
    b, t_local, _ = ytmp.shape
    # overlap-add as ``ratio`` shifted adds over hop blocks: frame t's j-th
    # hop chunk lands on block t + j
    blocks = ytmp.reshape(b, t_local, ratio, step)
    acc = ytmp.new_zeros((b, t_local + ratio - 1, step))
    for j in range(ratio):
        acc = acc + F.pad(blocks[:, :, j, :], (0, 0, j, ratio - 1 - j))
    flat = acc.reshape(b, -1)
    local, tail = flat[:, :t_local * step], flat[:, t_local * step:]
    recv = mesh.right_ppermute(tail)
    local = torch.cat([local[:, :halo] + recv, local[:, halo:]], dim=-1)
    env = torch.as_tensor(_wss_period(window_name, n_fft, step),
                          device=spec.device).repeat(t_local)
    return local / env


def hpss_sharded(mesh: Mesh, spec_mag, kernel_size: int = 31, power: float = 2.0):
    """Time-sharded HPSS masks.  ``spec_mag``: the rank's (files, F,
    T_local) magnitudes.  The harmonic median runs along time over
    ``kernel_size // 2`` frames of halo from each neighbour ('symmetric'
    edges at the global ends); the percussive median runs along frequency,
    shard-local.  Returns (mask_harm, mask_perc)."""
    from ..ops.decompose import _symmetric_pad, softmask

    half = kernel_size // 2
    if half > spec_mag.shape[-1]:
        raise ValueError(f"a shard of {spec_mag.shape[-1]} frames is shorter than the "
                         f"median's halo of {half}")
    left, right = mesh.exchange("time", to_left=spec_mag[..., :half],
                                to_right=spec_mag[..., -half:])
    if mesh.axis_index("time") == 0:
        left = spec_mag[..., :half].flip(-1)
    if mesh.axis_index("time") == mesh.shape["time"] - 1:
        right = spec_mag[..., -half:].flip(-1)
    ext = torch.cat([left, spec_mag, right], dim=-1)
    harm = torch.sort(ext.unfold(-1, kernel_size, 1), dim=-1).values[..., half]
    fext = _symmetric_pad(spec_mag.transpose(-1, -2), half, half)
    perc = torch.sort(fext.unfold(-1, kernel_size, 1), dim=-1).values[..., half]
    perc = perc.transpose(-1, -2)
    return (softmask(harm, perc, power=power, split_zeros=True),
            softmask(perc, harm, power=power, split_zeros=True))


def renoise_sharded(mesh: Mesh, x, profile, gain: float, n_fft: int = 1024,
                    step: int = 256, window_name: str = "blackmanharris"):
    """Time-sharded masked denoise of the rank's (files, local) block:
    sharded STFT -> the renoiser's per-bin threshold gain mask (``gain`` dB
    at or below the (n_freqs,) dB ``profile``, 0 dB above; the dense tier's
    ``_mask_fac``) -> sharded iSTFT."""
    from ..pipelines.renoiser import _mask_fac

    spec = stft_sharded(mesh, x, n_fft, step, window_name)
    mag_db = 20.0 * torch.log10(torch.abs(spec) + 1e-7)
    prof = torch.as_tensor(np.asarray(profile, np.float32), device=x.device)
    fac = _mask_fac(mag_db, prof, float(gain))
    return istft_sharded(mesh, spec * fac, n_fft, step, window_name)


def heal_sharded(mesh: Mesh, x, gain_db, n_fft: int = 512, step: int = 128,
                 window_name: str = "blackmanharris"):
    """Time-sharded dropout healing: sharded STFT -> dB boost mask (the
    rank's (files, n_freqs, T_local) block of ``gain_db``, 0 = untouched)
    -> sharded iSTFT."""
    spec = stft_sharded(mesh, x, n_fft, step, window_name)
    g = torch.as_tensor(np.asarray(gain_db, np.float32), device=x.device)
    return istft_sharded(mesh, spec * torch.pow(10.0, g / 20.0), n_fft, step,
                         window_name)


def cog_sharded(mesh: Mesh, spec_mag, NL0, NU0, tolerance, fft_size: int, sr: int):
    """Time-sharded Center-of-Gravity tracking with the band handed from
    shard to shard.  Frame t+1's band depends on frame t's result
    (wow_detection.py:256-291), so the shards form a chain: shard d waits
    for shard d-1's (NL, NU) carry, runs its local scan through
    ``cog_step_core`` (the dense scan's step) and sends its carry on.  The
    result equals the dense scan bit for bit.

    ``spec_mag``: the rank's (files, F, T_local) magnitudes; ``NL0``/``NU0``
    the rank's (files,) initial bands.  Returns (files, T_local) cogs."""
    from ..models.trackers import cog_step_core
    from ..ops.fourier import fft_freqs

    dev = spec_mag.device
    with np.errstate(divide="ignore"):
        lff = torch.as_tensor(np.log2(np.maximum(fft_freqs(fft_size, sr), 1e-12))
                              .astype(np.float32), device=dev)
    carry = torch.stack([torch.as_tensor(np.asarray(NL0), dtype=torch.int32, device=dev),
                         torch.as_tensor(np.asarray(NU0), dtype=torch.int32, device=dev)])
    carry = mesh.recv_left(carry).clone()
    out = []
    for b in range(spec_mag.shape[0]):
        # a row at a time on contiguous (T, F) frames, as the dense scan runs
        frames = spec_mag[b].transpose(0, 1).contiguous()
        nl, nu, cogs = carry[0, b], carry[1, b], []
        for t in range(frames.shape[0]):
            nl, nu, cog = cog_step_core(frames[t], nl, nu, lff, tolerance, fft_size, sr)
            cogs.append(cog)
        carry[0, b], carry[1, b] = nl, nu
        out.append(torch.stack(cogs))
    mesh.send_right(carry)
    return torch.stack(out)


def adaptive_peak_sharded(mesh: Mesh, spec_mag, carry0, tolerance_st,
                          mode: str, fft_size: int, sr: int):
    """Time-sharded adapt_band peak tracking with the history handed from
    shard to shard (wow_detection.py:142-187): like :func:`cog_sharded`, a
    chain of local scans through ``adaptive_step_core``, each starting from
    the 4-deep log2-frequency history of its left neighbour.

    ``spec_mag``: the rank's (files, F, T_local) block; ``carry0``: the
    rank's (files, 4) initial history (oldest first).  Returns (files,
    T_local) frequencies."""
    from ..models.trackers import adaptive_step_core

    dev = spec_mag.device
    hist = mesh.recv_left(torch.as_tensor(np.asarray(carry0, np.float32),
                                          device=dev)).clone()
    out = []
    for b in range(spec_mag.shape[0]):
        frames = spec_mag[b].transpose(0, 1).contiguous()
        h = tuple(hist[b, k] for k in range(4))
        freqs = []
        for t in range(frames.shape[0]):
            h, f = adaptive_step_core(frames[t], h, tolerance_st, mode, fft_size, sr)
            freqs.append(f)
        hist[b] = torch.stack(h)
        out.append(torch.stack(freqs) if freqs else spec_mag.new_zeros(0))
    mesh.send_right(hist)
    return torch.stack(out)


# ------------------------------------------------------------ fused restore

def _split_total(ci, cf, x):
    """Total of ``x`` over the last axis as an exact (int64, frac < 1)
    pair, given the exclusive split prefixes (ci, cf) of x."""
    xi = torch.floor(x[..., -1])
    s = cf[..., -1] + (x[..., -1] - xi)
    w = torch.floor(s)
    return ci[..., -1].to(torch.int64) + xi.to(torch.int64) + w.to(torch.int64), s - w


def _cross_shard_exclusive(mesh: Mesh, ti, tf, axis: str = "time"):
    """Exclusive prefix over ``axis`` of the shards' (int64, frac) totals:
    one all_gather of the D totals, then each shard sums its predecessors
    in split arithmetic, in shard order (the carry the dense
    ``_split_cumsum_exclusive`` scan computes sequentially).  The pair
    travels as one float64 tensor, exact for integers below 2**53."""
    both = mesh.all_gather(torch.stack([ti.to(torch.float64), tf.to(torch.float64)]),
                           axis)  # (D, 2, ...)
    oi, of = torch.zeros_like(ti), torch.zeros_like(tf)
    for d in range(mesh.axis_index(axis)):
        nf = of + both[d, 1].to(tf.dtype)
        w = torch.floor(nf)
        oi = oi + both[d, 0].to(torch.int64) + w.to(torch.int64)
        of = nf - w
    return oi, of


def _sharded_split_exclusive(mesh: Mesh, vals, axis: str = "time"):
    """Globally exclusive split cumsum of (..., T_local) positive float32
    values sharded along ``axis``: shard-local exact prefixes
    (``_split_cumsum_exclusive``) plus one all_gather carry.  Returns
    (int64, float32 frac in [0, 1))."""
    from ..pipelines.respeeder_device import _split_cumsum_exclusive

    ci, cf = _split_cumsum_exclusive(vals)
    ti, tf = _split_total(ci, cf, vals)
    oi, of = _cross_shard_exclusive(mesh, ti, tf, axis)
    nf = cf + of[..., None]
    w = torch.floor(nf)
    return ci.to(torch.int64) + oi[..., None] + w.to(torch.int64), nf - w


def _overlap_rows(a, Tl: int, d: int):
    """Shard d's frames [d*Tl, d*Tl + Tl] of a (..., F_total) frame-rate
    array: one frame of overlap with the right neighbour."""
    return a[..., d * Tl: d * Tl + Tl + 1]


FLAT_CAP = 1 << 31  # samples of a rank's flattened signal: the sinc's anchors are int32


def _fused_halos(step: int, max_n: int, nt: int, drift: int, base_slack: int = 16):
    """(Hl, Hr): the samples the fused sinc reads from the left and right
    neighbour shards."""
    U = nt + drift
    return U + base_slack, (max_n - step) + U + base_slack


def flat_row_samples(S: int, step: int, max_n: int, nt: int, drift: int,
                     base_slack: int = 16) -> int:
    """Samples one row of an ``S``-sample shard takes in the flattened
    signal of :func:`restore_fused_sharded`'s single sinc launch: the shard,
    its two halos and the zero guard between rows
    (``respeeder_device._flatten_takes``)."""
    Hl, Hr = _fused_halos(step, max_n, nt, drift, base_slack)
    return S + Hl + Hr + max_n + 2 * (nt + drift)


def fused_sharded_plan(mesh: Mesh, x, NL, NU, n_fft: int, step: int,
                       zeropad: int = 1, max_n: int = None, nt: int = 50,
                       drift: int = 32, window_name: str = "blackmanharris",
                       band=None, speed_curve=None, base_slack: int = 16,
                       chunk_frames: int = 4096, share_curve: bool = False,
                       lengths=None):
    """The plan half of :func:`restore_fused_sharded` (same arguments):
    tracking, centring, dithered counts and base positions on the mesh,
    then the halo-extended shard the sinc reads.  Returns a dict with
    ``ext`` (B, S + Hl + Hr), ``speeds`` (B, Tl + 1), ``nn`` (B, Tl) int32,
    ``anchors`` (B, Tl) int32 window anchors in ``ext``, ``base_int`` (B,
    Tl) int64 global positions, ``base_frac`` (B, Tl) and ``max_n``."""
    from ..pipelines.respeeder_device import (
        _f32, banded_refined_chunk, centre_speeds, exact_log_center, inv_count_limbs,
        log2_speeds, log_center_for_band, quantized_log_sums, segment_advances)

    n_time, idx = mesh.shape["time"], mesh.axis_index("time")
    dev = x.device
    B, S = x.shape
    batch, total = B * mesh.shape["files"], S * n_time
    if S % step or n_fft % step:
        raise ValueError("the shard length and n_fft must be multiples of step")
    pad = n_fft // 2
    if n_fft > S:
        raise ValueError("shard must cover the frame halo")
    Tl, ratio = S // step, n_fft // step
    F_total = total // step + 1
    if max_n is None:
        max_n = int(step * 1.25)
    Hl, Hr = _fused_halos(step, max_n, nt, drift, base_slack)
    if Hl > S or Hr > S:
        raise ValueError("halos must fit one neighbour shard")
    num_bins = n_fft * zeropad // 2 + 1
    NL, NU = np.asarray(NL, np.int32), np.asarray(NU, np.int32)
    if NL.shape != (F_total,) or NU.shape != (F_total,):
        raise ValueError(f"NL/NU must be ({F_total},)")
    if band is None:
        band = (max(0, int(NL.min()) - 1), min(num_bins, int(NU.max()) + 1))
    lo, hi = int(band[0]), int(band[1])
    center = log_center_for_band((lo, hi))
    rows = slice(mesh.axis_index("files") * B, (mesh.axis_index("files") + 1) * B)
    d_bound = min(0.9, max(drift - 2, 1) / max_n)
    len_b = None
    if lengths is not None:
        lengths_h = np.asarray(lengths, np.int64)
        if lengths_h.shape != (batch,):
            raise ValueError(f"lengths must be ({batch},)")
        len_b = torch.as_tensor(lengths_h[rows], device=dev)
        inv_b = torch.as_tensor(inv_count_limbs(lengths_h[rows] // step + 1), device=dev)

    if speed_curve is None:
        # reflect-centred frames: frame t covers x[t*step - pad, ... + n_fft)
        left, right = mesh.exchange("time", to_left=x[..., :pad], to_right=x[..., -pad:])
        if idx == 0:
            left = x[..., 1:pad + 1].flip(-1)
        if idx == n_time - 1:
            right = x[..., -pad - 1:-1].flip(-1)
        ext = torch.cat([left, x, right], dim=-1)  # (B, S + n_fft)
        n_frames = Tl + 1
        n_chunks = -(-n_frames // chunk_frames)
        span = (chunk_frames + ratio - 1) * step
        extp = F.pad(ext, (0, max(0, n_chunks * chunk_frames * step + span
                                  - ext.shape[-1])))
        pad_t = n_chunks * chunk_frames - n_frames
        nl = F.pad(torch.as_tensor(_overlap_rows(NL, Tl, idx), device=dev), (0, pad_t),
                   value=lo + 1)
        nu = F.pad(torch.as_tensor(_overlap_rows(NU, Tl, idx), device=dev), (0, pad_t),
                   value=lo + 2)
        # one row and one chunk at a time: every tracking GEMM has the dense
        # tier's (chunk_frames, n_fft) shape, so each frame's peak is the
        # dense tier's bit for bit
        refined = torch.stack([torch.cat([
            banded_refined_chunk(
                extp[b, c * chunk_frames * step: c * chunk_frames * step + span],
                nl[c * chunk_frames:(c + 1) * chunk_frames],
                nu[c * chunk_frames:(c + 1) * chunk_frames], n_fft, step, zeropad,
                window_name, (lo, hi), chunk_frames)
            for c in range(n_chunks)])[:n_frames] for b in range(B)])
        ls = log2_speeds(refined)  # (B, Tl + 1)
        # the exact partition-invariant mean over all F_total frames: integer
        # limbs summed over the shards; the overlap frame counts once (only
        # the last shard owns frame T)
        mask = torch.ones(Tl + 1, dtype=torch.float32, device=dev)
        mask[-1] = 1.0 if idx == n_time - 1 else 0.0
        inv = None
        if len_b is not None:
            # a mixed-length batch: the mean runs over each take's own frames
            # (global frame <= length // step, markers.py:190-192)
            gframe = idx * Tl + torch.arange(Tl + 1, device=dev)
            mask = mask * (gframe[None, :] <= (len_b // step)[:, None])
            inv = inv_b
        limbs = mesh.psum(torch.stack(quantized_log_sums(ls, center, mask=mask)), "time")
        mean = exact_log_center(tuple(limbs), F_total, center, inv_limbs=inv)
        speeds = centre_speeds(ls, mean[:, None])
    else:
        sc = np.asarray(speed_curve, np.float32)
        if sc.shape != (batch, F_total):
            raise ValueError(f"speed_curve must be ({batch}, {F_total})")
        speeds = torch.as_tensor(np.ascontiguousarray(_overlap_rows(sc[rows], Tl, idx)),
                                 device=dev)
    if share_curve:
        # the channels of one take ride the files axis and resample through
        # row 0's curve (resampling.py:211-231)
        speeds = mesh.all_gather(speeds, "files", tiled=True)[:1].expand(B, -1)
    speeds = torch.clamp(speeds, min=_f32(1.0 / (1.0 + d_bound)),
                         max=_f32(1.0 / (1.0 - d_bound))).contiguous()
    s_lo, s_hi = speeds[:, :-1], speeds[:, 1:]
    n_raw = step * (s_lo + s_hi) / 2.0

    # globally dithered output counts, in exact split arithmetic
    ci, cf = _sharded_split_exclusive(mesh, n_raw)
    whole = torch.floor(cf + n_raw)
    inc_i = ci + whole.to(torch.int64)
    inc_f = cf + n_raw - whole
    rounded = inc_i + (inc_f >= 0.5).to(torch.int64)
    pred0 = ci[:, :1] + (cf[:, :1] >= 0.5).to(torch.int64)
    nn = torch.clamp(torch.diff(rounded, dim=-1, prepend=pred0), 0, max_n).to(torch.int32)

    # exact segment advances, then the global base positions
    A = segment_advances(s_lo.reshape(-1), s_hi.reshape(-1), nn.reshape(-1),
                         max_n).reshape(nn.shape)
    base_int, base_frac = _sharded_split_exclusive(mesh, A)

    # the sinc windows are shard-local given the halos
    left, right = mesh.exchange("time", to_left=x[..., :Hr], to_right=x[..., -Hl:])
    ext = torch.cat([left, x, right], dim=-1)  # (B, S + Hl + Hr)
    if len_b is not None:
        # taps past a take's real end read zero, as in its solo run: the rows
        # carry the reflect continuation for the tracker only
        gpos = (idx * S - Hl) + torch.arange(ext.shape[-1], device=dev)
        ext = torch.where(gpos[None, :] < len_b[:, None], ext, 0.0)
    anchors = (base_int - (idx * S - Hl)).to(torch.int32)
    return {"ext": ext, "speeds": speeds, "nn": nn, "anchors": anchors,
            "base_int": base_int, "base_frac": base_frac, "max_n": max_n}


def restore_fused_sharded(mesh: Mesh, x, NL, NU, n_fft: int, step: int,
                          zeropad: int = 1, max_n: int = None, nt: int = 50,
                          drift: int = 32, window_name: str = "blackmanharris",
                          band=None, speed_curve=None, base_slack: int = 16,
                          chunk_frames: int = 4096, backend: str = "auto",
                          share_curve: bool = False, lengths=None,
                          wrap_bits: int = 32):
    """The fused restoration step on a ('files', 'time') mesh: banded-DFT
    tracking, the exact dithered plan and the banded sinc, as
    ``respeeder_device.restore_fused_device``, with the global couplings as
    collectives (module docstring).

    ``x``: the rank's (files, S) block of the (batch, total) batch; each row
    tracks its OWN curve, or with ``share_curve`` every row resamples
    through row 0's (the files axis then carries the channels of one take).
    ``NL``/``NU``: global (total // step + 1,) band limits.
    ``speed_curve``: optional global (batch, total // step + 1) curve that
    replaces tracking.  ``lengths``: optional global (batch,) real lengths
    of a mixed-length batch whose rows carry the solo reflect continuation
    past their end (``batch.load_batch(reflect_tail=n_fft)``): the first
    ``length // step`` segments of a row are then bit-equal to its solo run.
    ``backend``: "pallas" (K1) or "xla" (K2's plan entry); "auto" picks K1
    for a CUDA tensor.  All the rank's rows go through one kernel launch.

    The rank's rows flatten into one signal whose anchors are int32:
    ``B * flat_row_samples(S, ...)`` must stay under 2**31 (ValueError
    otherwise; ``batch`` sizes its worlds so).

    Returns the rank's (padded (B, Tl, max_n), nn (B, Tl) int32, base_int
    (B, Tl) int64, base_frac (B, Tl)), Tl = S // step."""
    from ..pipelines.respeeder_device import _flatten_takes, _sinc_segments_backend

    B, S = x.shape
    n_flat = B * flat_row_samples(S, step, max_n or int(step * 1.25), nt, drift,
                                  base_slack)
    if n_flat >= FLAT_CAP:
        raise ValueError(
            f"{B} row(s) of a {S}-sample shard flatten to {n_flat} samples, past the "
            f"int32 anchors of the sinc ({FLAT_CAP}): shard the time axis over more "
            "ranks, or give a rank fewer rows")
    p = fused_sharded_plan(mesh, x, NL, NU, n_fft, step, zeropad, max_n, nt, drift,
                           window_name, band, speed_curve, base_slack, chunk_frames,
                           share_curve, lengths)
    max_n = p["max_n"]
    flat = _flatten_takes(p["ext"], p["speeds"], p["nn"], p["anchors"], p["base_frac"],
                          max_n, nt, drift)
    padded = _sinc_segments_backend(flat, max_n, nt, drift, backend)
    return (padded.reshape(x.shape[0], -1, max_n), p["nn"],
            wrap_base_int(p["base_int"], wrap_bits), p["base_frac"])


def wrap_base_int(base_int, bits: int = 32):
    """``base_int`` (tensor or array) wrapped to signed ``bits`` when bits <
    32 (the JAX tier's test hook for its int32 wrap), else as it is."""
    if bits >= 32:
        return base_int
    half = 1 << (bits - 1)
    return ((base_int + half) & ((1 << bits) - 1)) - half


def unwrap_base_int(base_int_np, base_frac_np=None, bits: int = 32):
    """Host: unwrap a mod-``2**bits`` ``base_int`` plan into true int64
    sample positions.

    Segment advances are small positives (~hop), so the wrapped difference
    of consecutive entries IS the true delta, and an int64 prefix sum
    rebuilds the positions.  Works on (T,) or (files, T) arrays; the first
    entry anchors the unwrap.  Returns int64 positions, or float64
    ``base + frac`` when ``base_frac_np`` is given.  Reference anchor: the
    implicit int64 positions of the float64 host planner,
    resampling.py:93-137."""
    w = np.asarray(base_int_np).astype(np.int64)
    half = np.int64(1) << (bits - 1)
    # wrapped deltas, recovered to signed range: exact for |true| < 2**(bits-1)
    d = ((np.diff(w, axis=-1) + half) & ((np.int64(1) << bits) - 1)) - half
    first = w[..., :1]
    pos = np.concatenate(
        [first, first + np.cumsum(d, axis=-1)], axis=-1)
    if base_frac_np is not None:
        return pos.astype(np.float64) + np.asarray(base_frac_np, np.float64)
    return pos


def compact_padded_host(padded_np, n_np, n_out=None):
    """Host: (T, max_n) padded grid + (T,) counts -> flat (n_out,) output,
    the twin of ``respeeder_device.compact_output`` (which takes the host
    plan dict instead)."""
    T, max_n = padded_np.shape
    mask = np.arange(max_n)[None, :] < np.asarray(n_np)[:, None]
    flat = np.asarray(padded_np)[mask]
    return flat[:n_out] if n_out is not None else flat


# ------------------------------------------------------------ fixed length

def lag_windows(mesh: Mesh, x, sampletimes, lags, hop: int = 256, nt: int = 50,
                drift: int = 32, base_slack: int = 4):
    """The gathered windows and grids of :func:`lag_resample_sharded` (same
    arguments): (buf (B * Tseg, hop + 2U), bs, rel, in_seg (B * Tseg, hop)),
    the rank's rows flattened for one K2 launch."""
    from ..models.trackers import interp_rows

    dev = x.device
    B, S = x.shape
    if S % hop:
        raise ValueError("the shard length must be a multiple of hop")
    Tseg = S // hop
    st = np.asarray(sampletimes, np.float64)
    lg = np.asarray(lags, np.float64)
    max_dev = float(np.max(np.abs(lg))) if len(lg) else 0.0
    U = nt + drift
    H = int(np.ceil(max_dev)) + U + base_slack + hop
    if H > S:
        raise ValueError("max lag must fit one neighbour shard")
    L = hop + 2 * U
    left, right = mesh.exchange("time", to_left=x[..., :H], to_right=x[..., -H:])
    ext = torch.cat([left, x, right], dim=-1)  # (B, S + 2H)
    # positions are pos_j = j - lag(j): the big output index stays exact (an
    # int) and only the lag is interpolated, relative to the shard.  JAX
    # interpolates the lag in float32 (the TPU has no float64), which puts
    # a lag of 2.9 s at 44.1 kHz 0.008 samples off; here it is float64,
    # and only the small in-segment offsets are rounded to float32
    f64 = torch.float64
    g0 = float(mesh.axis_index("time") * S)
    jg_rel = torch.arange(S + 1, dtype=f64, device=dev)
    lagc = interp_rows(jg_rel, torch.as_tensor(st - g0, device=dev),
                       torch.as_tensor(lg, device=dev)[None])[0]  # (S + 1,)
    dlag = lagc[1:] - lagc[:-1]
    bs = (1.0 / torch.clamp(1.0 - dlag, min=1e-6)).to(torch.float32).reshape(Tseg, hop)
    neg_lag = (-lagc[:S]).reshape(Tseg, hop)
    anchor_off = torch.floor(neg_lag[:, 0])
    kk = torch.arange(hop, dtype=f64, device=dev)[None, :]
    rel = (kk + (neg_lag - anchor_off[:, None])).to(torch.float32)
    anchor_off = anchor_off.to(torch.int32)
    start = torch.arange(Tseg, dtype=torch.int32, device=dev) * hop + anchor_off + H - U
    idx2 = torch.clamp(start[:, None] + torch.arange(L, device=dev)[None, :], 0,
                       ext.shape[-1] - 1)
    buf = ext[:, idx2].reshape(B * Tseg, L)
    in_seg = torch.ones((B * Tseg, hop), dtype=torch.bool, device=dev)
    return buf, bs.repeat(B, 1), rel.repeat(B, 1), in_seg


def lag_resample_sharded(mesh: Mesh, x, sampletimes, lags, hop: int = 256,
                         nt: int = 50, drift: int = 32, base_slack: int = 4):
    """Time-sharded lag-curve varispeed resample, the tapesynch export on a
    mesh (pytapesynch_gui.py:145-155; positions ``interp(j, times, times -
    lags)``, resampling.py:189-206; cutoff ``fc = min(1/dp, 1)``).

    Positions stay within ``max|lags|`` of the output index, so each shard
    reads one halo of ``max|lag|`` plus the taps from each neighbour, and
    segments of ``hop`` outputs run K2's grid entry (its plain version on
    the CPU), all the rank's rows in one launch.  ``x``: the rank's (files,
    S) block (the files axis carries the channels, resampled through one
    curve); ``sampletimes``/``lags``: 1D host arrays in SAMPLES.  Returns
    the rank's (files, S) block of the fixed-length output."""
    buf, bs, rel, in_seg = lag_windows(mesh, x, sampletimes, lags, hop, nt, drift,
                                       base_slack)
    out = sinc_banded_gathered(buf, bs, rel, in_seg, nt, drift)
    return out.reshape(x.shape[0], -1)


def _masked_peak_local(spec_local, nl, nu):
    """Frame-parallel masked peak tracking: ``spec_local`` (..., F, T),
    ``nl``/``nu`` (T,) int bands; the dense trackers' peak gate and
    parabolic refinement (``masked_peak_refine``)."""
    from ..models.trackers import masked_peak_refine

    return masked_peak_refine(spec_local.transpose(-1, -2), nl, nu)


def _step_band(f0_hz: float, sr: int, n_fft: int, tolerance_st: float, n_frames: int):
    """The fixed (NL, NU) band of :func:`restore_step`: ``f0_hz`` plus or
    minus ``tolerance_st`` semitones (at least 2 bins), for ``n_frames``."""
    f0_bin = int(round(f0_hz * n_fft / sr))
    tol_bins = max(2, int(round(f0_bin * (2 ** (tolerance_st / 12) - 1))))
    return (np.full(n_frames, f0_bin - tol_bins, np.int32),
            np.full(n_frames, f0_bin + tol_bins + 1, np.int32))


def step_positions(mesh: Mesh, x, f0_hz: float, sr: int, n_fft: int = 512,
                   step: int = 128, tolerance_st: float = 2.0, band=None, lengths=None):
    """The tracking half of :func:`restore_step`: sharded STFT, peak per
    frame, the speed curve centred over the whole take (a psum), and each
    output's input position relative to the shard, with the global offset
    carried by an all_gather.  ``lengths``: optional global (batch,) real
    lengths of a padded batch; the centring mean then runs over the frames
    that start inside each take.  Returns (rel (B, local), per-sample speed
    (B, local))."""
    n_time = mesh.shape["time"]
    B, local = x.shape
    if local % step:
        raise ValueError("the shard length must be a multiple of step")
    n_frames_local = local // step
    if band is None:
        NL, NU = _step_band(f0_hz, sr, n_fft, tolerance_st, n_frames_local * n_time)
    else:
        NL, NU = (np.asarray(b, np.int32) for b in band)
        if NL.shape != (n_frames_local * n_time,) or NU.shape != NL.shape:
            raise ValueError("band arrays must be (total // step,)")
    idx = mesh.axis_index("time")
    sl = slice(idx * n_frames_local, (idx + 1) * n_frames_local)
    window = torch.as_tensor(get_window("hann", n_fft), device=x.device)
    ext = halo_exchange_right(mesh, x, n_fft - step)
    mag = torch.abs(_stft_local(ext, n_fft, step, window, 1, n_frames_local))
    peak = _masked_peak_local(mag, torch.as_tensor(NL[sl], device=x.device),
                              torch.as_tensor(NU[sl], device=x.device))
    log_speed = torch.log2(torch.clamp(peak, min=1.0))
    # centre the curve over all shards, then the fixed-length positions
    # cumsum(1/speed) with the shards' totals before this one as the offset
    if lengths is None:
        mean = mesh.psum(torch.sum(log_speed, dim=-1, keepdim=True), "time") / (
            n_frames_local * n_time)
    else:
        f = mesh.axis_index("files")
        own = torch.as_tensor(np.asarray(lengths, np.int64)[f * B:(f + 1) * B],
                              device=x.device)
        start = (idx * n_frames_local + torch.arange(n_frames_local, device=x.device)) * step
        inside = (start[None, :] < own[:, None]).to(log_speed.dtype)
        sums = mesh.psum(torch.stack([torch.sum(log_speed * inside, dim=-1),
                                      torch.sum(inside, dim=-1)]), "time")
        mean = (sums[0] / sums[1])[:, None]
    up = torch.repeat_interleave(torch.pow(2.0, log_speed - mean), step, dim=-1)
    inv = 1.0 / up
    totals = mesh.all_gather(torch.sum(inv, dim=-1, keepdim=True), "time")  # (D, B, 1)
    offset = torch.sum(totals[:idx], dim=0)
    pos = torch.cumsum(inv, dim=-1) - inv + offset
    return pos - idx * local, up


def step_halo(mesh: Mesh, rel, drift_halo: int) -> int:
    """The drift halo a shard reads from each neighbour: ``drift_halo``, or
    more where the positions run further from their output index on any
    shard (at most a shard)."""
    local = rel.shape[-1]
    j = torch.arange(local, dtype=rel.dtype, device=rel.device)
    need = mesh.pmax(torch.max(torch.abs(rel - j)).reshape(1), "time")
    return min(local, max(int(drift_halo), int(math.ceil(float(need))) + 2))


def restore_step(mesh: Mesh, x, f0_hz: float, sr: int, n_fft: int = 512,
                 step: int = 128, tolerance_st: float = 2.0, drift_halo: int = 256,
                 interp: str = "linear", nt: int = 8, band=None, lengths=None):
    """Fixed-length sharded wow/flutter restoration step: sharded STFT ->
    frame-parallel peak tracking -> global speed normalisation -> fixed
    length varispeed resample with a bounded drift halo, linear or the
    banded windowed sinc (K2's grid entry, all rows in one launch).

    ``x``: the rank's (files, local) block.  ``band``: optional global
    per-frame (NL, NU) int arrays of length total // step (trail-driven
    tracking); by default ``f0_hz`` plus or minus ``tolerance_st``.
    ``lengths``: optional global (batch,) real lengths of a padded batch
    (:func:`step_positions`).  Returns the rank's (files, local) block.

    JAX's step reads ``drift_halo`` samples of the right neighbour only and
    clamps positions behind a shard's first sample, or past the halo, to
    the edge.  Here each shard reads the halo from both neighbours, and the
    halo grows to the largest distance the positions run from their output
    index (0.8 % wow at 0.55 Hz is +-444 samples at 192 kHz); the take's
    start still clamps as in JAX.  Where JAX's positions stay inside its
    halo, the outputs are JAX's up to the float32 rounding of the speed
    mean, which scales every position by up to ~2e-6."""
    B, local = x.shape
    rel, up = step_positions(mesh, x, f0_hz, sr, n_fft, step, tolerance_st, band, lengths)
    halo = step_halo(mesh, rel, drift_halo)
    if interp == "linear":
        lo = 0.0 if mesh.axis_index("time") == 0 else -float(halo)
        left, right = mesh.exchange("time", to_left=x[..., :halo], to_right=x[..., -halo:])
        ext = torch.cat([left, x, right], dim=-1)
        rel = torch.clamp(rel, lo, local + halo - 2.0) + halo
        i0 = torch.floor(rel).to(torch.int64)
        frac = rel - i0
        g0 = torch.gather(ext, -1, i0)
        g1 = torch.gather(ext, -1, i0 + 1)
        return g0 * (1 - frac) + g1 * frac
    buf, bs, rel_s, in_seg, seg_drift = step_windows(mesh, x, rel, up, step, tolerance_st,
                                                     halo, nt)
    return sinc_banded_gathered(buf, bs, rel_s, in_seg, nt, seg_drift).reshape(B, local)


def step_windows(mesh: Mesh, x, rel, up, step: int, tolerance_st: float,
                 drift_halo: int, nt: int):
    """The windowed-sinc inputs of :func:`restore_step`: segment-local
    anchors bound the in-segment drift, so the banded shift-MAC applies
    (2 nt taps, hann taper, fc = min(speed, 1)).  Returns (buf (B * Tseg,
    step + 2 U2), bs, rel, in_seg (B * Tseg, step), seg_drift)."""
    B, local = x.shape
    seg_drift = max(4, int(np.ceil(step * (2 ** (tolerance_st / 12) - 1))) + 2)
    U2 = nt + seg_drift
    drift_halo = min(drift_halo, local - U2 - 2)  # the left halo fits one shard
    Hl2 = U2 + 2 + drift_halo
    left, right = mesh.exchange("time", to_left=x[..., :drift_halo],
                                to_right=x[..., -Hl2:])
    ext2 = torch.cat([left, x, right], dim=-1)
    Tseg, L2 = local // step, step + 2 * U2
    lo = 0.0 if mesh.axis_index("time") == 0 else -float(drift_halo)
    ps = torch.clamp(rel, lo, local + drift_halo - 1.0).reshape(B, Tseg, step)
    bi = torch.floor(ps[..., 0]).to(torch.int64)
    rel_s = ps - bi[..., None].to(torch.float32)
    start = bi + Hl2 - U2
    idx2 = torch.clamp(start[..., None] + torch.arange(L2, device=x.device), 0,
                       ext2.shape[-1] - 1)
    buf = torch.gather(ext2, 1, idx2.reshape(B, -1)).reshape(B * Tseg, L2)
    in_seg = torch.ones((B * Tseg, step), dtype=torch.bool, device=x.device)
    return (buf, up.reshape(B * Tseg, step).contiguous(),
            rel_s.reshape(B * Tseg, step).contiguous(), in_seg, seg_drift)
