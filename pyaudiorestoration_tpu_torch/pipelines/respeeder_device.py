"""Device-resident wow/flutter restoration on PyTorch/CUDA (counterpart of
pyaudiorestoration_tpu/pipelines/respeeder_device.py).

``respeed --fast`` (``restore_file_fast``):

  read (the port's native C++ codec, utils/audio_io.py)
   -> pilot-tone probe (host)
   -> banded peak tracking -> speed curve centred with exact limbs  (device)
   -> position plan in float64                                      (host)
   -> banded windowed-sinc resample, kernel K1                      (device)
   -> compaction of the padded grid                                 (device)
   -> write

The fused entries (``restore_fused_device`` for one take,
``restore_fused_takes`` for a batch of independent takes) keep the plan on
the device: the float64 cumsums become exact (int32, float32 frac) split
cumsums and fixed-order tree sums (``_plan_from_speeds``), and the sinc runs
as K1 (backend ``"pallas"``) or as the gathered-window tier with K2
(``"xla"``).

Takes over 1 GiB decoded, or past the int32 sample cap, go to the streamed
tier (``restore_file_streamed``): pass 1 tracks block by block, the plan is
made on the host, pass 2 resamples tile by tile with K1 and appends to the
output file.

Every stage has the JAX function's name, arguments and conventions, so the
parity tests feed both the same inputs.  Public entries take ``device``
("cuda" by default; "cpu" runs the kernels' plain PyTorch versions).
"""

from __future__ import annotations

import functools
import logging
import math
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.sinc_banded import (fixed_order_cumsum, gather_windows,
                                   segment_grids, sinc_banded_gathered_plan,
                                   sinc_banded_plan)
from ..models.trackers import masked_peak_refine
from ..ops.fourier import get_window
from ..ops.fourier import reflect_pad as _reflect_pad
from ..utils import audio_io, streaming
from ..utils.convert import plan_to_torch
from ..utils.device import resolve_device

__all__ = ["track_speed_device", "track_peaks_span", "banded_refined_chunk",
           "normalize_speeds", "quantized_log_sums", "exact_log_center",
           "inv_count_limbs", "log_center_for_band", "plan_positions",
           "plan_positions_fast", "segment_grids", "fixed_order_cumsum",
           "segment_advances", "sinc_banded_segments", "sinc_banded_device",
           "run_banded_sinc", "compact_output", "compact_padded_device",
           "restore_device", "restore_fused_device", "restore_fused_takes",
           "restore_file_streamed", "restore_file_fast"]


# ---------------------------------------------------------------- tracking

@functools.lru_cache(maxsize=16)
def _banded_dft_matrix(n_fft: int, zeropad: int, lo: int, hi: int) -> np.ndarray:
    """(n_fft, 2*(hi-lo)) real DFT matrix computing rFFT bins [lo, hi) of the
    zero-padded transform — cos columns then sin columns, pre-scaled by the
    reference's 1/sqrt(n_fft) norm."""
    ang = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(lo, hi)) / (n_fft * zeropad)
    scale = 1.0 / np.sqrt(n_fft)
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32) * scale


def _frames(xs, n_fft: int, step: int, count: int, window_name: str):
    """Windowed frames (..., count, n_fft); frame p starts at xs[..., p*step]."""
    window = torch.as_tensor(get_window(window_name, n_fft), device=xs.device)
    return xs.unfold(-1, n_fft, step)[..., :count, :] * window


def banded_refined_chunk(xs, nl, nu, n_fft: int, step: int, zeropad: int,
                         window_name: str, band, chunk: int):
    """Banded-DFT peak refinement over one chunk of frames.

    ``xs``: (..., span) raw samples; ``nl``/``nu``: (..., chunk) absolute
    bin limits.  The frames x (n_fft, 2*nb) product is a plain float32
    ``torch.matmul`` (TF32 off, :func:`~..utils.device.pin_fp32`), the
    counterpart of JAX's ``Precision.HIGHEST`` dot."""
    lo, hi = int(band[0]), int(band[1])
    nb = hi - lo
    # float64 on the host (the float32 cos/sin times a float64 scale); cast
    # to float32 as jnp.asarray does in the reference
    dft = torch.as_tensor(_banded_dft_matrix(n_fft, zeropad, lo, hi),
                          dtype=torch.float32, device=xs.device)
    ri = torch.matmul(_frames(xs, n_fft, step, chunk, window_name), dft)
    mag = torch.sqrt(ri[..., :nb] ** 2 + ri[..., nb:] ** 2) + 1e-7
    return masked_peak_refine(mag, nl - lo, nu - lo, bin_offset=float(lo))


def track_peaks_span(xp, NL, NU, n_frames: int, n_fft: int, step: int,
                     zeropad: int = 1, window_name: str = "blackmanharris",
                     chunk_frames: int = 4096, band=None):
    """Refined (parabolic) peak bin per frame over an already-padded span:
    frame t covers ``xp[t*step : t*step+n_fft]``.

    ``band``: optional (lo, hi) bin bounds covering every [NL, NU) window plus
    one neighbour; when given, the spectrum is the banded DFT product, else
    the full rFFT of length ``n_fft*zeropad``.  Frames go through in chunks of
    ``chunk_frames`` so memory stays bounded for long takes."""
    if n_fft % step:
        raise ValueError(f"step {step} must divide n_fft {n_fft}")
    ratio = n_fft // step
    n_chunks = -(-n_frames // chunk_frames)
    span = (chunk_frames + ratio - 1) * step
    xp2 = F.pad(xp.to(torch.float32),
                (0, max(0, n_chunks * chunk_frames * step + span - xp.shape[0])))
    pad_t = n_chunks * chunk_frames - n_frames
    num_bins = n_fft * zeropad // 2 + 1
    if band is not None:
        lo = max(0, int(band[0]))
        hi = min(num_bins, int(band[1]))
    else:
        lo, hi = 0, num_bins
    NLp = F.pad(NL, (0, pad_t), value=lo + 1)
    NUp = F.pad(NU, (0, pad_t), value=lo + 2)
    refined = []
    for c in range(n_chunks):
        xs = xp2[c * chunk_frames * step: c * chunk_frames * step + span]
        nl = NLp[c * chunk_frames: (c + 1) * chunk_frames]
        nu = NUp[c * chunk_frames: (c + 1) * chunk_frames]
        if band is not None:
            refined.append(banded_refined_chunk(xs, nl, nu, n_fft, step, zeropad,
                                                window_name, (lo, hi), chunk_frames))
            continue
        frames = _frames(xs, n_fft, step, chunk_frames, window_name)
        spec = torch.fft.rfft(frames, n=n_fft * zeropad, dim=-1) / math.sqrt(n_fft)
        mag = torch.abs(spec) + 1e-7
        refined.append(masked_peak_refine(mag, nl - lo, nu - lo, bin_offset=float(lo)))
    return torch.cat(refined)[:n_frames]


def track_speed_device(x, NL, NU, n_fft: int, step: int, zeropad: int = 1,
                       window_name: str = "blackmanharris",
                       chunk_frames: int = 4096, band=None, frame_mask=None,
                       inv_limbs=None):
    """Reflect-centred framing + banded peak tracking + speed normalisation,
    all on ``x``'s device.  Returns speeds (T,) centred on ~1.0."""
    xp = _reflect_pad(x.to(torch.float32), n_fft // 2)
    n_frames = (xp.shape[0] - n_fft) // step + 1
    refined = track_peaks_span(xp, NL, NU, n_frames, n_fft, step, zeropad,
                               window_name, chunk_frames, band)
    return normalize_speeds(refined, center=log_center_for_band(band),
                            frame_mask=frame_mask, inv_limbs=inv_limbs)


def log_center_for_band(band):
    """Static log2 pivot for the exact mean, derived from the band bound."""
    if band is None:
        return None
    return float(np.log2(max((band[0] + band[1]) / 2.0, 2.0)))


_INV_LN2_F32 = float(np.float32(1.0 / np.log(2.0)))


def _f32(v: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak-typed scalar."""
    return float(np.float32(v))


def _carry(hi, lo, base=4096.0):
    """One base-4096 carry step on exact-integer float32 limbs."""
    c = torch.floor(lo / base)
    return hi + c, lo - c * base


def quantized_log_sums(ls, center: float, mask=None):
    """Exact integer sum of ``q = round((ls - center) * 2**16)`` as three
    float32 base-4096 limbs (h2, h1, lo).  Every partial sum is an integer
    below 2**24, so the limbs are the same in any order of summation: the
    card's reductions give the JAX reference's limbs bit for bit.

    ``ls`` may be float64 (see :func:`normalize_speeds`): ``ls - center``
    is then rounded to float32 once, as the reference's fused
    multiply-subtract rounds it.  ``center`` is taken as a float32, as JAX
    takes a Python float."""
    q = torch.round((ls - _f32(center)).to(torch.float32) * 65536.0)
    if mask is not None:
        q = q * mask
    T = q.shape[-1]
    qb = F.pad(q, (0, (-T) % (128 * 128)))
    qb = qb.reshape(*q.shape[:-1], -1, 128, 128)
    bs = torch.sum(qb, dim=-1)                  # block sums, exact (< 2**23)
    h1, lo = _carry(torch.zeros_like(bs), bs)   # base-4096 digits per block
    h1g = torch.sum(h1, dim=-1)                 # group stage, < 2**19
    log_ = torch.sum(lo, dim=-1)
    h2g, h1g = _carry(torch.zeros_like(h1g), h1g)
    h2 = torch.sum(h2g, dim=-1)
    h1 = torch.sum(h1g, dim=-1)
    lo = torch.sum(log_, dim=-1)
    h1, lo = _carry(h1, lo)
    h2, h1 = _carry(h2, h1)
    return h2, h1, lo


def exact_log_center(limbs, count: int, center: float, inv_limbs=None):
    """Mean of the quantized log speeds from exact limb sums, with the JAX
    reference's fixed division expression (float32 operands)."""
    h2, h1, lo = limbs
    h1, lo = _carry(h1, lo)
    h2, h1 = _carry(h2, h1)
    inv = 1.0 / 65536.0
    if inv_limbs is not None:
        c0, c1, c2 = inv_limbs[..., 0], inv_limbs[..., 1], inv_limbs[..., 2]
    else:
        c0, c1, c2 = 4096.0 * 4096.0 / count, 4096.0 / count, 1.0 / count
    return center + (h2 * c0 + h1 * c1 + lo * c2) * inv


def inv_count_limbs(counts):
    """Host: frame counts -> the (..., 3) float32 1/count limb factors of
    :func:`exact_log_center`, divided in float64 as for a static count."""
    c = np.asarray(counts, np.float64)
    return np.stack([4096.0 * 4096.0 / c, 4096.0 / c, 1.0 / c],
                    axis=-1).astype(np.float32)


def normalize_speeds(refined, center: float = None, frame_mask=None,
                     inv_limbs=None):
    """Refined peak bins -> speed curve centred on ~1.0 (TraceLine
    normalisation, markers.py:190-192).  ``center`` enables the exact
    partition-invariant mean; ``None`` keeps the plain float mean.
    ``frame_mask``/``inv_limbs`` restrict the mean to a padded take's frames."""
    # jnp.log2(x) is log(x) / ln 2, which XLA turns into log(x) times the
    # float32 constant 1/ln 2 and fuses with the subtraction of the pivot or
    # mean into one FMA: the centred value is rounded once.  torch.log2 and
    # a separately rounded product each differ on ~20% of bins by an ulp of
    # log2(bin) (~1e-6 at bin 500); through the quantized mean and the
    # centring that is a biased ~6e-7 relative speed error, which the plan
    # accumulates over a take.  So the product is kept exact in float64 and
    # each centring rounds once to float32.  log and pow are evaluated in
    # float64 and rounded to float32: that is the same value on the card and
    # on the CPU (their float32 log and pow differ by an ulp on ~1% of
    # inputs, enough to move the plan), and XLA's float32 log and pow agree
    # with it on ~99% and ~99.9% of inputs.
    f64 = torch.float64
    ls = torch.log(torch.clamp(refined, min=1.0).to(f64)).to(torch.float32).to(f64)
    ls = ls * _INV_LN2_F32
    if center is None:
        mean = torch.mean(ls.to(torch.float32))
    else:
        mean = exact_log_center(
            quantized_log_sums(ls, center, mask=frame_mask),
            ls.shape[-1], center, inv_limbs=inv_limbs)
    centred = (ls - mean.to(f64)).to(torch.float32)
    return torch.pow(2.0, centred.to(f64)).to(torch.float32)

# ------------------------------------------------------------ host plan

def plan_positions(speeds_np, hop: int, num_input_samples: int, t0_samples: float = 0.0):
    """Host-side position plan from a frame-rate speed curve (float64, tiny).

    Returns a dict with per-segment output counts ``n``, float64 base offsets
    split into (int32, float32), segment output starts, n_out and max_n.
    Mirrors the reference's dithering exactly (resampling.py:107-137) via the
    rounded-cumsum closed form.
    """
    speeds = np.asarray(speeds_np, dtype=np.float64)
    T = len(speeds) - 1
    n_raw = hop * (speeds[:-1] + speeds[1:]) / 2.0
    cum = np.cumsum(n_raw)
    n = np.diff(np.round(np.concatenate([[0.0], cum]))).astype(np.int64)
    n = np.maximum(n, 0)
    max_n = int(n.max()) if T else 0
    # exact segment advance A_i = sum_k 1/bs_(i,k) on the padded grid (f64)
    k = np.arange(max_n)[None, :]
    denom = np.maximum(n[:, None] - 1, 1).astype(np.float64)
    bs = speeds[:-1, None] + k / denom * (speeds[1:, None] - speeds[:-1, None])
    inv = np.where(k < n[:, None], 1.0 / bs, 0.0)
    A = inv.sum(axis=1)
    base = t0_samples + np.concatenate([[0.0], np.cumsum(A)[:-1]])
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    # end trim (reference: nearest position to the input end)
    ends = base + A
    n_out = int(n.sum())
    over = np.nonzero(ends >= num_input_samples)[0]
    if len(over):
        i = over[0]
        # refine inside segment i: count positions <= crossing
        rel = np.cumsum(inv[i])
        j = int(np.argmin(np.abs(base[i] + rel[: max(1, n[i])] - num_input_samples)))
        n_out = int(starts[i] + j)
    base_int = np.floor(base).astype(np.int32)
    base_frac = (base - base_int).astype(np.float32)
    # drift bound for the banded kernel: max |anchor - output index| in-segment
    rel = np.cumsum(inv, axis=1) + base_frac[:, None]
    m = np.where(k < n[:, None], np.abs(np.round(rel) - k), 0)
    drift = int(m.max()) + 1 if m.size else 1
    return {
        "n": n.astype(np.int32), "base_int": base_int, "base_frac": base_frac,
        "starts": starts.astype(np.int64), "max_n": max_n, "n_out": n_out,
        "drift": drift,
    }


def plan_positions_fast(speeds_np, hop: int, num_input_samples: int,
                        t0_samples: float = 0.0):
    """O(n_segments) position plan via the exact digamma closed form.

    The per-segment advance ``A_i = sum_k 1/(a + c k)`` equals
    ``(psi(a/c + n) - psi(a/c)) / c`` exactly (digamma recurrence), so the
    5M-element reciprocal grid of :func:`plan_positions` collapses to two
    digamma evaluations per segment.  Same outputs (float64 parity ~1e-9).
    """
    from scipy.special import digamma

    speeds = np.asarray(speeds_np, dtype=np.float64)
    n_raw = hop * (speeds[:-1] + speeds[1:]) / 2.0
    cum = np.cumsum(n_raw)
    n = np.diff(np.round(np.concatenate([[0.0], cum]))).astype(np.int64)
    n = np.maximum(n, 0)
    max_n = int(n.max()) if len(n) else 0
    a = speeds[:-1].copy()
    b = speeds[1:].copy()
    # use the positive-slope orientation so digamma args stay positive
    swap = b < a
    a2 = np.where(swap, b, a)
    b2 = np.where(swap, a, b)
    denom = np.maximum(n - 1, 1)
    c = (b2 - a2) / denom
    tiny = np.abs(c) < 1e-12
    c_safe = np.where(tiny, 1.0, c)
    with np.errstate(invalid="ignore", divide="ignore"):
        A_slope = (digamma(a2 / c_safe + n) - digamma(a2 / c_safe)) / c_safe
    A = np.where(tiny | (n <= 1), np.where(n >= 1, n / a2, 0.0), A_slope)
    # n == 1 single-sample segments evaluate bs at k=0 -> 1/a (original a!)
    one = n == 1
    if one.any():
        A[one] = 1.0 / a[one]
    base = t0_samples + np.concatenate([[0.0], np.cumsum(A)[:-1]])
    starts = np.concatenate([[0], np.cumsum(n)[:-1]])
    ends = base + A
    n_out = int(n.sum())
    over = np.nonzero(ends >= num_input_samples)[0]
    if len(over):
        i = over[0]
        k = np.arange(max(1, n[i]))
        bs = speeds[i] + k / max(n[i] - 1, 1) * (speeds[i + 1] - speeds[i])
        rel = np.cumsum(1.0 / bs)
        j = int(np.argmin(np.abs(base[i] + rel - num_input_samples)))
        n_out = int(starts[i] + j)
    base_int = np.floor(base).astype(np.int32)
    base_frac = (base - base_int).astype(np.float32)
    # analytic drift bound: |anchor - k| <= max_n * max|1/speed - 1| + 2
    dmax = float(np.max(np.abs(1.0 / speeds - 1.0))) if len(speeds) else 0.0
    drift = int(np.ceil(max_n * dmax)) + 2
    return {
        "n": n.astype(np.int32), "base_int": base_int, "base_frac": base_frac,
        "starts": starts.astype(np.int64), "max_n": max_n, "n_out": n_out,
        "drift": drift,
    }


def _drift_bucket(drift: int) -> int:
    """Power-of-two bucket (>= 8) of a plan's drift bound, as the JAX tiers
    bucket it to keep their compile caches warm."""
    d = 8
    while d < drift:
        d *= 2
    return d


# ------------------------------------------------------------ banded sinc

def _flatten_takes(xb, speeds, nn, bi, bf, max_n: int, nt: int, drift: int):
    """Concatenate a batch of rows (B, n) with a zero guard between them wide
    enough that no sinc window crosses into the next row, and flatten every
    per-segment plan array, offsetting anchors by the row stride."""
    B, n = xb.shape
    guard = max_n + 2 * (nt + drift)
    R = n + guard
    sig_flat = F.pad(xb, (0, guard)).reshape(B * R)
    offs = (torch.arange(B, dtype=torch.int32, device=xb.device) * R)[:, None]
    return (sig_flat, speeds[:, :-1].reshape(-1), speeds[:, 1:].reshape(-1),
            nn.reshape(-1), (bi + offs).reshape(-1), bf.reshape(-1))


SEG_TILE = 4096  # rows per call on the CPU, so the plain version's grids bound memory


def _row_chunks(T: int, device):
    """Row ranges of the sinc calls: all T rows in one kernel launch on the
    card; ``SEG_TILE``-row chunks on the CPU (the plain version's (rows,
    max_n) grids and shift-MAC temporaries bound memory there)."""
    step = T if torch.device(device).type == "cuda" else SEG_TILE
    return [(a, a + step) for a in range(0, T, max(step, 1))]


def _cat_rows(rows, max_n: int, device):
    if not rows:
        return torch.zeros((0, max_n), dtype=torch.float32, device=device)
    return torch.cat(rows)


def sinc_banded_segments(sig, s_lo, s_hi, n, base_int, base_frac, max_n: int,
                         nt: int = 50, drift: int = 32):
    """The gathered-window tier over per-segment endpoint speeds: gather the
    (rows, max_n + 2U) window buffer, zero outside the signal, and run K2's
    plan entry on it (its plain version on the CPU).  Returns (T, max_n)."""
    U = nt + drift
    return _cat_rows([
        sinc_banded_gathered_plan(gather_windows(sig, base_int[a:b], max_n + 2 * U, U),
                                  s_lo[a:b], s_hi[a:b], n[a:b], base_frac[a:b], max_n,
                                  nt, drift)
        for a, b in _row_chunks(n.shape[0], sig.device)], max_n, sig.device)


def sinc_banded_device(sig, speeds, n, base_int, base_frac, max_n: int,
                       nt: int = 50, drift: int = 32):
    """The gathered-window tier for an (n,) or (C, n) signal through one
    plan (a (T+1,) speed curve); channels run one after the other.  Returns
    (T, max_n) or (C, T, max_n)."""
    if sig.dim() == 2:
        return torch.stack([sinc_banded_device(ch, speeds, n, base_int, base_frac,
                                               max_n, nt, drift)
                            for ch in sig])
    return sinc_banded_segments(sig, speeds[:-1], speeds[1:], n, base_int,
                                base_frac, max_n, nt, drift)


def _sinc_backend(backend: str, device) -> str:
    """Resolve a sinc backend.  ``"pallas"``: the flattened segments with
    each window loaded inside the kernel, K1.  ``"xla"``: the gathered
    window buffer, K2 on the card and its plain version on the CPU.
    ``"auto"``: ``"pallas"`` for a CUDA tensor, ``"xla"`` for a CPU one (as
    JAX picks the Pallas kernel on a TPU).  Any other value raises."""
    if backend == "auto":
        return "pallas" if torch.device(device).type == "cuda" else "xla"
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown sinc backend {backend!r} "
                         "(use 'auto', 'pallas' or 'xla')")
    return backend


def _sinc_segments_backend(flat, max_n: int, nt: int, drift: int,
                           backend: str = "pallas"):
    """Banded sinc over the flattened segments of :func:`_flatten_takes`:
    K1's plan entry, or the gathered tier."""
    sig_flat, s_lo, s_hi, n, base_int, base_frac = flat
    if _sinc_backend(backend, sig_flat.device) == "xla":
        return sinc_banded_segments(*flat, max_n, nt, drift)
    return _cat_rows([
        sinc_banded_plan(sig_flat, base_int[a:b], s_lo[a:b], s_hi[a:b], n[a:b],
                         base_frac[a:b], max_n, nt, drift)
        for a, b in _row_chunks(n.shape[0], sig_flat.device)], max_n, sig_flat.device)


def run_banded_sinc(sig, speeds, n, base_int, base_frac, max_n: int,
                    nt: int, drift: int, backend: str = "auto"):
    """Banded sinc for a (C, n) or (n,) signal through one shared plan: the
    channels flatten into the segment axis with zero guards, as the JAX
    Pallas path does, so either backend (:func:`_sinc_backend`) launches
    its kernel once on the card.  A row's window is the same in the
    flattened signal as in its channel (the guard is wider than a window),
    so "xla" equals :func:`sinc_banded_device` channel by channel.  Returns
    (C, T, max_n) or (T, max_n)."""
    x = sig if sig.dim() == 2 else sig[None]
    C = x.shape[0]
    flat = _flatten_takes(
        x, speeds.expand(C, -1), n.expand(C, -1), base_int.expand(C, -1),
        base_frac.expand(C, -1), max_n, nt, drift)
    out = _sinc_segments_backend(flat, max_n, nt, drift, backend).reshape(C, -1, max_n)
    return out if sig.dim() == 2 else out[0]


# ------------------------------------------------------------ device plan

def _tree_sum_last(x):
    """Fixed-order binary-tree sum over the last axis by explicit adds: pad
    to even at each level, then add the even and odd halves.  A library
    reduction may add in any order (XLA's did, per enclosing program, and
    moved ``base_frac`` by ~2.7e-4); this DAG is the same everywhere, so the
    plan is bit-deterministic on the card and equal to the JAX reference's
    on the CPU."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = F.pad(x, (0, 1))
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def segment_advances(s_lo, s_hi, n, max_n: int, seg_chunk: int = 32768):
    """Exact per-segment input advances ``A_i = n_i + sum_k (1/bs_ik - 1)``
    on the padded grid, ``seg_chunk`` rows at a time so memory holds one
    (seg_chunk, max_n) reciprocal grid; each row's value is the same
    whatever the chunk.  ``inv - 1`` is exact for inv in [0.5, 2]
    (Sterbenz), so the tree sum only rounds the small residual.

    The lerped speed is rounded once, as a fused multiply-add: XLA's CPU
    backend contracts ``lo + k/denom * (hi - lo)`` into one inside the
    jitted plan, which moves ~3 % of the grid by an ulp and ~0.4 % of the
    advances.  A product of two float32 is exact in float64, so one float64
    add and one rounding to float32 give the fused result."""
    dev = s_lo.device
    f64 = torch.float64
    kf = torch.arange(max_n, dtype=torch.float32, device=dev)[None, :]
    ki = torch.arange(max_n, dtype=torch.int32, device=dev)[None, :]
    out = []
    for a in range(0, n.shape[0], seg_chunk):
        lo, hi, nn = s_lo[a:a + seg_chunk], s_hi[a:a + seg_chunk], n[a:a + seg_chunk]
        denom = torch.clamp(nn[:, None] - 1, min=1).to(torch.float32)
        bs = ((kf / denom).to(f64) * (hi - lo)[:, None].to(f64)
              + lo[:, None].to(f64)).to(torch.float32)
        valid = ki < nn[:, None]
        inv = torch.where(valid, 1.0 / bs, 0.0)
        e = torch.where(valid, inv - 1.0, 0.0)
        out.append(nn.to(torch.float32) + _tree_sum_last(e))
    if not out:
        return torch.zeros(0, dtype=torch.float32, device=dev)
    return torch.cat(out)


def _split_cumsum_exclusive(x, block: int = 1024, sub: int = 32):
    """Exclusive cumsum over the last axis of positive float32 values as an
    exact (int32, float32 frac in [0, 1)) pair.

    Integer parts accumulate exactly; fractional parts in two levels of
    small float32 partial sums (``sub``-element runs inside ``block``-element
    blocks, floors taken at each level, each float cumsum in XLA's order
    through :func:`fixed_order_cumsum`), then one sequential carry over the
    block totals: a loop over blocks, vectorised over the leading axes, in
    the reference's order of operations.  The frac error stays under ~2e-4
    whatever the total.  Contract: the int32 part wraps past 2**31 (about
    2.2 h of 192 kHz output); longer takes belong to the streamed tier."""
    T = x.shape[-1]
    lead = x.shape[:-1]
    S = block // sub
    xb = F.pad(x, (0, (-T) % block)).reshape(*lead, -1, S, sub)
    xi = torch.floor(xb)
    xf = xb - xi
    # exclusive cumsums inside each sub run (frac magnitude <= sub); the
    # integer cumsums are exact in any order
    ci_in = torch.cumsum(xi, dim=-1) - xi
    cf_in = fixed_order_cumsum(xf) - xf
    cfi = torch.floor(cf_in)
    cff = cf_in - cfi
    # sub-run totals, normalized
    s_last = cff[..., -1] + xf[..., -1]
    sti = ci_in[..., -1] + xi[..., -1] + cfi[..., -1] + torch.floor(s_last)
    stf = s_last - torch.floor(s_last)
    # exclusive prefix of sub-run totals inside the block (frac mag <= S)
    bti = torch.cumsum(sti, dim=-1) - sti
    btf = fixed_order_cumsum(stf) - stf
    bfi = torch.floor(btf)
    bff = btf - bfi
    # per-element in-block combine (block offset still zero)
    f0 = bff[..., None] + cff
    w0 = torch.floor(f0)
    ints0 = bti[..., None] + bfi[..., None] + ci_in + cfi + w0  # exact ints
    fr0 = f0 - w0
    s2 = fr0[..., -1, -1] + xf[..., -1, -1]
    ti = (ints0[..., -1, -1] + xi[..., -1, -1] + torch.floor(s2)).to(torch.int32)
    tf = s2 - torch.floor(s2)
    # the sequential carry over block totals, one block a step
    whole = torch.zeros(lead, dtype=torch.int32, device=x.device)
    frac = torch.zeros(lead, dtype=torch.float32, device=x.device)
    off_i, off_f = [], []
    for b in range(ti.shape[-1]):
        off_i.append(whole)
        off_f.append(frac)
        frac = frac + tf[..., b]
        w = torch.floor(frac)
        whole = whole + ti[..., b] + w.to(torch.int32)
        frac = frac - w
    if not off_i:
        return torch.zeros(x.shape, dtype=torch.int32, device=x.device), x.clone()
    nf = torch.stack(off_f, dim=-1)[..., None, None] + fr0
    w = torch.floor(nf)
    ints = (torch.stack(off_i, dim=-1)[..., None, None] + ints0.to(torch.int32)
            + w.to(torch.int32))
    fracs = nf - w
    return ints.reshape(*lead, -1)[..., :T], fracs.reshape(*lead, -1)[..., :T]


def _plan_from_speeds(speeds, step: int, max_n: int, drift: int):
    """Device position plan from (..., F) frame-rate speeds: clip to the
    drift contract -> dithered counts -> segment advances -> base positions.
    Returns (clipped speeds, n, base_int, base_frac), the last three
    (..., F - 1).  The clip bounds round to float32 as JAX rounds
    weak-typed Python floats."""
    # |anchor - k| <= drift needs |1/speed - 1| <= (drift-2)/max_n: a take
    # whose wow exceeds what ``drift`` budgets gets a clipped curve
    d_bound = min(0.9, max(drift - 2, 1) / max_n)
    speeds = torch.clamp(speeds, min=_f32(1.0 / (1.0 + d_bound)),
                         max=_f32(1.0 / (1.0 - d_bound)))
    s_lo, s_hi = speeds[..., :-1], speeds[..., 1:]
    n_raw = step * (s_lo + s_hi) / 2.0
    # dithered output counts n_i = round(cum_i) - round(cum_{i-1}), the
    # cumsum held as an exact (int, frac) pair
    ci, cf = _split_cumsum_exclusive(n_raw)
    whole = torch.floor(cf + n_raw)
    inc_i = ci + whole.to(torch.int32)
    inc_f = cf + n_raw - whole
    rounded = inc_i + (inc_f >= 0.5).to(torch.int32)
    n = torch.diff(rounded, dim=-1, prepend=torch.zeros_like(rounded[..., :1]))
    n = torch.clamp(n, 0, max_n)
    A = segment_advances(s_lo.reshape(-1), s_hi.reshape(-1), n.reshape(-1),
                         max_n).reshape(n.shape)
    base_int, base_frac = _split_cumsum_exclusive(A)
    return speeds, n, base_int, base_frac


def _fused_plan(mono, NL, NU, n_fft: int, step: int, zeropad: int, max_n: int,
                nt: int, drift: int, window_name: str, band, frame_mask=None,
                inv_limbs=None):
    """Device position plan of one take: tracking, then
    :func:`_plan_from_speeds`.  The front half of ``restore_fused_device``
    and ``restore_fused_takes``.  (JAX pins this subgraph with an
    ``optimization_barrier``; PyTorch runs op by op and fuses nothing, so
    the plan is the same whatever consumes it.)"""
    speeds = track_speed_device(mono, NL, NU, n_fft, step, zeropad, window_name,
                                band=band, frame_mask=frame_mask,
                                inv_limbs=inv_limbs)
    return _plan_from_speeds(speeds, step, max_n, drift)


# ------------------------------------------------------------ compaction

def compact_output(padded_np, plan):
    """Host: padded (T, max_n) -> flat (n_out,) using the segment counts."""
    T, max_n = padded_np.shape
    k = np.arange(max_n)[None, :]
    mask = k < plan["n"][:, None]
    return padded_np[mask][: plan["n_out"]].astype(np.float32)


def compact_padded_device(padded, n, out_len: int):
    """Device compaction: padded (..., T, max_n) + segment counts ``n`` (T,)
    -> (contiguous (..., out_len), n_out).

    Output sample ``j`` lives in the last segment whose start is <= j: each
    segment's index and start are scattered (``amax``, so zero-count
    duplicates resolve to the last segment) at its start and filled forward
    with a cumulative max, all in int32 as the JAX reference does.  It moves
    the same float32 values, so it is bit-exact; entries past ``n_out`` are
    zero.  Starts at or past ``out_len`` are dropped (JAX's ``mode="drop"``).
    """
    T, max_n = padded.shape[-2:]
    dev = padded.device
    csum = torch.cumsum(n.to(torch.int32), dim=0, dtype=torch.int32)
    n_out = csum[-1]
    off = F.pad(csum[:-1], (1, 0))  # segment starts
    keep = off < out_len
    idx = off[keep].to(torch.int64)
    zeros = torch.zeros(out_len, dtype=torch.int32, device=dev)
    t_at = zeros.scatter_reduce(
        0, idx, torch.arange(T, dtype=torch.int32, device=dev)[keep], reduce="amax")
    o_at = zeros.scatter_reduce(0, idx, off[keep], reduce="amax")
    t = torch.cummax(t_at, dim=0).values
    j = torch.arange(out_len, dtype=torch.int32, device=dev)
    k = torch.clamp(j - torch.cummax(o_at, dim=0).values, 0, max_n - 1)
    flat = padded.reshape(*padded.shape[:-2], T * max_n)
    out = flat[..., t.to(torch.int64) * max_n + k]
    return torch.where(j < n_out, out, 0.0), n_out


# ------------------------------------------------------------ entry points

def _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr):
    """Fixed NL/NU bin band around a target frequency (semitone tolerance)."""
    num_bins = fft_size * zeropad // 2 + 1
    tol = tolerance_st / 12.0
    NL = max(1, min(num_bins - 1,
                    int(round(max(1.0, f0_hz * 2 ** -tol) * fft_size * zeropad / sr))))
    NU = max(1, min(num_bins - 1,
                    int(round(min(sr / 2, f0_hz * 2 ** tol) * fft_size * zeropad / sr))))
    return NL, NU


def _probe_f0(x, sr):
    """Strongest-bin pilot-tone probe over the first ~2^18 samples."""
    probe = np.asarray(x[: min(len(x), 1 << 18)], dtype=np.float32)
    spec = np.abs(np.fft.rfft(probe * np.hanning(len(probe))))
    return float(np.argmax(spec[10:]) + 10) / len(probe) * sr


def _restore_padded(mono, sig, sr: int, f0_hz: float, tolerance_st: float,
                    fft_size: int, fft_overlap: int, zeropad: int,
                    sinc_quality: int):
    """Track ``mono`` (n,), plan on the host, resample ``sig`` ((n,) or
    (C, n)) through the shared curve.  Returns (padded, plan)."""
    dev = mono.device
    hop = fft_size // fft_overlap
    n = int(mono.shape[0])
    n_frames = (n + (fft_size // 2) * 2 - fft_size) // hop + 1
    NL, NU = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
    NLs = torch.full((n_frames,), NL, dtype=torch.int32, device=dev)
    NUs = torch.full((n_frames,), NU, dtype=torch.int32, device=dev)
    speeds = track_speed_device(mono, NLs, NUs, fft_size, hop, zeropad,
                                band=(NL - 1, NU + 1))
    speeds_np = speeds.cpu().numpy()  # ~T floats, the only mid-path download
    plan = plan_positions_fast(speeds_np, hop, n)
    p = plan_to_torch(plan, dev)
    padded = run_banded_sinc(sig, speeds, p["n"], p["base_int"], p["base_frac"],
                             p["max_n"], int(sinc_quality), _drift_bucket(p["drift"]))
    return padded, plan


def restore_device(sig, sr: int, f0_hz: float, tolerance_st: float = 1.0,
                   fft_size: int = 4096, fft_overlap: int = 8, zeropad: int = 2,
                   sinc_quality: int = 50, device="cuda"):
    """Device-resident restoration of a mono signal (n,) around a fixed
    target frequency.  Returns (padded (T, max_n) tensor, host plan)."""
    dev = resolve_device(device)
    x = torch.as_tensor(sig, dtype=torch.float32, device=dev)
    return _restore_padded(x, x, sr, f0_hz, tolerance_st, fft_size,
                           fft_overlap, zeropad, sinc_quality)


def restore_fused_device(x, NL, NU, n_fft: int, step: int, zeropad: int,
                         max_n: int, nt: int = 50, drift: int = 64,
                         window_name: str = "blackmanharris",
                         backend: str = "xla", band=None, device="cuda"):
    """End-to-end restoration with the plan on the device: tracking ->
    speed curve -> dithered position plan -> banded sinc, with no host
    round trip in between.

    ``x`` is (n,) mono or (C, n) channels of one take: tracking runs on
    channel 0 and every channel resamples through its curve (the
    reference's export contract, resampling.py:211-231).  ``NL``/``NU``:
    (n // step + 1,) per-frame band limits.  ``backend``: see
    :func:`_sinc_backend`.  Returns the (T, max_n) padded grid, with a
    leading channel axis for (C, n) input; entries with k >= n_i are zero."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    NL = torch.as_tensor(NL, dtype=torch.int32, device=dev)
    NU = torch.as_tensor(NU, dtype=torch.int32, device=dev)
    mono = x[0] if x.dim() == 2 else x
    speeds, n, base_int, base_frac = _fused_plan(
        mono, NL, NU, n_fft, step, zeropad, max_n, nt, drift, window_name, band)
    return run_banded_sinc(x, speeds, n, base_int, base_frac, max_n, nt, drift,
                           backend)


def _restore_fused_takes(xb, NLb, NUb, n_fft: int, step: int, zeropad: int,
                         max_n: int, nt: int, drift: int, window_name: str,
                         backend: str, band, lengths, device):
    """:func:`restore_fused_takes`, also returning the plan ``(n, base_int,
    base_frac)``, each (B, T)."""
    dev = resolve_device(device)
    xb = torch.as_tensor(xb, dtype=torch.float32, device=dev)
    NLb = torch.as_tensor(NLb, dtype=torch.int32, device=dev)
    NUb = torch.as_tensor(NUb, dtype=torch.int32, device=dev)
    B, N = xb.shape
    xt = xs = xb
    fmasks = invs = [None] * B
    if lengths is not None:
        # per-take boundary regeneration: tracking frames that cross a take's
        # end see the solo run's reflect pad, sinc taps past it read zero
        lengths_h = np.asarray(lengths, np.int64)
        invs = torch.as_tensor(inv_count_limbs(lengths_h // step + 1), device=dev)
        L = torch.as_tensor(lengths_h, dtype=torch.int32, device=dev)[:, None]
        pos = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
        src = torch.where(pos < L, pos, torch.clamp(2 * (L - 1) - pos, 0, N - 1))
        xt = torch.gather(xb, 1, src.to(torch.int64))
        xs = torch.where(pos < L, xb, 0.0)
        frames = torch.arange(N // step + 1, dtype=torch.int32, device=dev)[None, :]
        fmasks = (frames <= L // step).to(torch.float32)
    # one take at a time, so each tracking GEMM keeps the solo run's
    # (chunk_frames, n_fft) shape and a row is bit-identical to its solo run
    speeds = torch.stack([
        track_speed_device(xt[b], NLb[b], NUb[b], n_fft, step, zeropad,
                           window_name, band=band, frame_mask=fmasks[b],
                           inv_limbs=invs[b])
        for b in range(B)])
    speeds, nn, bi, bf = _plan_from_speeds(speeds, step, max_n, drift)
    flat = _flatten_takes(xs, speeds, nn, bi, bf, max_n, nt, drift)
    out = _sinc_segments_backend(flat, max_n, nt, drift, backend)
    return out.reshape(B, -1, max_n), nn, bi, bf


def restore_fused_takes(xb, NLb, NUb, n_fft: int, step: int, zeropad: int,
                        max_n: int, nt: int = 50, drift: int = 64,
                        window_name: str = "blackmanharris",
                        backend: str = "xla", band=None, lengths=None,
                        device="cuda"):
    """A batch of INDEPENDENT takes: each row of ``xb`` (B, n) tracks its own
    speed curve and resamples through it (unlike ``restore_fused_device``'s
    (C, n), whose rows are channels of one take).  ``NLb``/``NUb``:
    (B, n // step + 1) per-take band limits.  The takes flatten into one
    segment axis, with zero guards between them, for one sinc pass.
    Returns (B, T, max_n) padded grids.

    ``lengths``: optional (B,) real sample counts of a mixed-length batch
    (rows padded to the common n).  Each take is then restored as its solo
    ``restore_fused_device`` run would be: tracking sees the take's reflect
    pad past its end, the centring mean runs over its own frames
    (markers.py:190-192) and sinc taps past its end read zero; its first
    ``length // step`` segments are bit-identical to the solo run's."""
    return _restore_fused_takes(xb, NLb, NUb, n_fft, step, zeropad, max_n, nt,
                                drift, window_name, backend, band, lengths,
                                device)[0]


def restore_file_streamed(audio_path, f0_hz=None, tolerance_st: float = 1.0,
                          fft_size: int = 4096, fft_overlap: int = 8,
                          zeropad: int = 2, sinc_quality: int = 50,
                          suffix: str = "", channel: int = 0, use_channels=None,
                          frames_per_block: int = 65536, seg_tile: int = 16384,
                          resume: bool = True, speed_curve=None, timings=None,
                          device="cuda"):
    """Larger-than-memory wow/flutter fix: two streamed passes over the file.

    Pass 1 reads ``frames_per_block``-frame spans through the native
    ``StreamReader``, reflects only at the true file edges, zero-pads each
    span to a fixed length and tracks its peaks on the device
    (``track_peaks_span``): the masked-peak tracker is frame-local, so the
    frames are those of the in-memory path.  The frame-rate speed curve and
    the position plan are the only whole-take state held (~16 bytes a
    frame).  Pass 2 resamples ``seg_tile`` segments at a time from a
    re-read input window, each tile through ``run_banded_sinc`` (K1 on the
    card) with tile-relative anchors, compacts it on the device and appends
    it through ``open_writer`` (so ``--flac-out`` applies).  Host memory
    peaks at one block whatever the take's length.

    Checkpoint/resume (``resume=True``): the pass-1 speed curve persists to
    ``<out>.speeds.npz``, keyed by the input's identity and the tracking
    config, with the JAX package's key and array names: a sidecar written by
    either package resumes in the other, and pass 2 restarts without
    re-tracking.  The sidecar is removed after a successful write.

    ``speed_curve``: frame-rate speeds (``n//hop + 1`` values) that skip
    tracking (streamed project replay, constant-ratio resampling).
    ``timings``: an optional dict the call fills with per-pass wall seconds
    under the JAX package's keys (``pass1_s``, ``plan_s``, ``pass2_s`` and
    their read / device / write parts) plus ``n``/``sr``/``n_out``.
    Returns the output path.
    """
    if timings is None:
        timings = {}
    dev = resolve_device(device)
    hop = fft_size // fft_overlap
    nt = int(sinc_quality)
    with audio_io.StreamReader(audio_path) as reader:
        sr, num_channels = reader.sample_rate, reader.channels
        n = int(reader.frames)
        channels = list(use_channels) if use_channels else list(range(num_channels))
        if f0_hz is None:
            f0_hz = _probe_f0(reader.read(0, min(n, 1 << 18))[:, channel], sr)
        NL, NU = _band_limits(f0_hz, tolerance_st, fft_size, zeropad, sr)
        pad = fft_size // 2
        n_frames = (n + 2 * pad - fft_size) // hop + 1
        frames_per_block = min(frames_per_block, n_frames)
        out_base = f"{os.path.splitext(audio_path)[0]}_res{suffix}"
        ckpt_path = f"{out_base}.speeds.npz"
        # the key holds the input's identity (size + mtime_ns), not only its
        # geometry: a replaced file with the same frame count must not
        # resume from the previous file's speed curve
        st = os.stat(audio_path)
        ckpt_key = np.asarray([n, num_channels, sr, fft_size, hop, zeropad,
                               NL, NU, channel, st.st_size, st.st_mtime_ns],
                              np.int64)

        speeds = None
        if speed_curve is not None:
            speeds = np.asarray(speed_curve, np.float64)
            if len(speeds) != n_frames:
                raise ValueError(f"speed_curve has {len(speeds)} values, "
                                 f"the take {n_frames} frames")
            resume = False  # nothing expensive to checkpoint
        if resume and os.path.exists(ckpt_path):
            try:
                ck = np.load(ckpt_path)
                if np.array_equal(ck["key"], ckpt_key):
                    speeds = ck["speeds"]
                    logging.info(f"Resuming pass 2 from {ckpt_path}")
            except Exception:
                pass
        if speeds is None:
            # ---- pass 1: streamed banded peak tracking (frame-exact)
            t_start = time.perf_counter()
            NLs = torch.full((frames_per_block,), NL, dtype=torch.int32, device=dev)
            NUs = torch.full((frames_per_block,), NU, dtype=torch.int32, device=dev)
            span_need = (frames_per_block - 1) * hop + fft_size
            refined_parts = []
            t_read = t_dev = 0.0
            for t0 in range(0, n_frames, frames_per_block):
                t1 = min(n_frames, t0 + frames_per_block)
                lo = t0 * hop - pad
                hi = (t1 - 1) * hop - pad + fft_size
                rlo, rhi = max(0, lo), min(n, hi)
                tr = time.perf_counter()
                blk = reader.read(rlo, rhi - rlo)[:, channel].astype(np.float32)
                t_read += time.perf_counter() - tr
                if lo < 0 or hi > n:  # reflect only at the true file edges
                    blk = np.pad(blk, (rlo - lo, hi - rhi), mode="reflect")
                blk = np.pad(blk, (0, span_need - len(blk)))
                td = time.perf_counter()
                refined = track_peaks_span(
                    torch.as_tensor(blk, device=dev), NLs, NUs, frames_per_block,
                    fft_size, hop, zeropad, band=(NL - 1, NU + 1)).cpu().numpy()
                t_dev += time.perf_counter() - td
                refined_parts.append(refined[: t1 - t0])
            timings["pass1_read_s"] = t_read
            timings["pass1_device_s"] = t_dev  # incl. block upload + curve download
            speeds = normalize_speeds(
                torch.as_tensor(np.concatenate(refined_parts), device=dev),
                center=log_center_for_band((NL - 1, NU + 1))).cpu().numpy()
            if resume:
                np.savez(ckpt_path, key=ckpt_key, speeds=speeds)
            timings["pass1_s"] = time.perf_counter() - t_start

        # ---- global position plan (host, frame-rate sized)
        t_start = time.perf_counter()
        plan = plan_positions_fast(speeds, hop, n)
        drift = _drift_bucket(plan["drift"])
        U = nt + drift
        max_n = int(plan["max_n"])
        T = len(plan["n"])
        seg_tile = min(seg_tile, T)  # a take shorter than a tile pads no rows
        speeds32 = speeds.astype(np.float32)
        out_path = out_base + "." + audio_io.out_ext()
        # ---- pass 2: tile the segment axis, re-read input windows, append.
        # The read span is padded to one fixed length for the whole file
        # (zeros past the real span never fall inside a window)
        bi_all = plan["base_int"]
        span_fix = max(
            int(bi_all[min(T, a + seg_tile) - 1]) - int(bi_all[a])
            for a in range(0, T, seg_tile)) + max_n + 2 * U + 2
        timings["plan_s"] = time.perf_counter() - t_start
        timings.update(n=n, sr=sr, n_out=int(plan["n_out"]))
        t_start = time.perf_counter()
        written = 0
        t_read = t_dev = t_write = 0.0
        with audio_io.open_writer(out_path, sr, len(channels)) as writer:
            for a in range(0, T, seg_tile):
                b = min(T, a + seg_tile)
                nseg = b - a
                lo = int(plan["base_int"][a]) - U
                hi = int(plan["base_int"][b - 1]) + max_n + U + 2
                rlo, rhi = max(0, lo), min(n, hi)
                tr = time.perf_counter()
                buf = reader.read(rlo, rhi - rlo)[:, channels]  # (span, C)
                t_read += time.perf_counter() - tr
                pad_s = span_fix - buf.shape[0]
                if pad_s > 0:
                    buf = np.pad(buf, ((0, pad_s), (0, 0)))
                td = time.perf_counter()
                sig_dev = torch.as_tensor(np.ascontiguousarray(buf.T), device=dev)
                # rows past nseg: no output (n = 0), speed 1
                n_t = np.zeros(seg_tile, np.int32)
                n_t[:nseg] = plan["n"][a:b]
                bi_t = np.zeros(seg_tile, np.int32)
                bi_t[:nseg] = plan["base_int"][a:b] - rlo
                bf_t = np.zeros(seg_tile, np.float32)
                bf_t[:nseg] = plan["base_frac"][a:b]
                s_t = np.ones(seg_tile + 1, np.float32)
                s_t[: nseg + 1] = speeds32[a: b + 1]
                n_dev = torch.as_tensor(n_t, device=dev)
                padded = run_banded_sinc(
                    sig_dev, torch.as_tensor(s_t, device=dev), n_dev,
                    torch.as_tensor(bi_t, device=dev), torch.as_tensor(bf_t, device=dev),
                    max_n, nt, drift)
                take = min(int(n_t.sum()), plan["n_out"] - written)
                tile_out, _ = compact_padded_device(padded, n_dev, take)
                tile_out = tile_out.T.contiguous().cpu().numpy()
                t_dev += time.perf_counter() - td
                tw = time.perf_counter()
                writer.write(tile_out)
                t_write += time.perf_counter() - tw
                written += take
                if written >= plan["n_out"]:
                    break
        timings["pass2_s"] = time.perf_counter() - t_start
        timings["pass2_read_s"] = t_read
        timings["pass2_device_dl_s"] = t_dev  # upload + compute + compaction + download
        timings["pass2_write_s"] = t_write
    if resume and os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # success: the checkpoint has served its purpose
    logging.info(f"Wrote {out_path}")
    return out_path


def restore_file_fast(audio_path, f0_hz=None, tolerance_st: float = 1.0,
                      fft_size: int = 4096, fft_overlap: int = 8, zeropad: int = 2,
                      sinc_quality: int = 50, suffix: str = "", channel: int = 0,
                      use_channels=None, stream="auto",
                      stream_threshold_bytes: int = 1 << 30, device="cuda"):
    """File-to-file wow/flutter fix through the device pipeline.

    Tracks on ``channel``, resamples all ``use_channels`` (default: all)
    through the shared speed curve (the reference's multi-channel export
    contract, resampling.py:211-231).  Auto-detects the pilot tone when
    ``f0_hz`` is None.  Returns the output path.

    ``stream``: True forces the two-pass larger-than-memory path
    (:func:`restore_file_streamed`); "auto" takes it when the DECODED size
    (header frames x channels x 4 bytes) exceeds ``stream_threshold_bytes``.
    Takes past the int32 sample cap always take it.
    """
    dev = resolve_device(device)
    # int32 sample counts cap the in-memory path at 2**31 samples
    # (compact_padded_device); longer takes stream through the int64 host plan
    int32_guard = streaming.decoded_bytes(audio_path) // 4 > (1 << 31) // 2
    if int32_guard or streaming.should_stream(audio_path, stream,
                                              stream_threshold_bytes):
        return restore_file_streamed(
            audio_path, f0_hz=f0_hz, tolerance_st=tolerance_st,
            fft_size=fft_size, fft_overlap=fft_overlap, zeropad=zeropad,
            sinc_quality=sinc_quality, suffix=suffix, channel=channel,
            use_channels=use_channels, device=dev)

    signal, sr, num_channels = audio_io.read_file(audio_path)
    channels = list(use_channels) if use_channels else list(range(num_channels))
    if f0_hz is None:
        f0_hz = _probe_f0(signal[:, channel], sr)
    sig = torch.as_tensor(np.ascontiguousarray(signal[:, channels].T), device=dev)
    if channel in channels:  # the tracking channel is already on the device
        mono = sig[channels.index(channel)]
    else:
        mono = torch.as_tensor(np.ascontiguousarray(signal[:, channel]), device=dev)
    padded, plan = _restore_padded(mono, sig, sr, f0_hz, tolerance_st, fft_size,
                                   fft_overlap, zeropad, sinc_quality)
    out_dev, _ = compact_padded_device(
        padded, torch.as_tensor(plan["n"], device=dev), int(plan["n_out"]))
    out = out_dev.T.contiguous().cpu().numpy()
    return audio_io.write_file(audio_path, out, sr, len(channels),
                               suffix=f"_res{suffix}")
