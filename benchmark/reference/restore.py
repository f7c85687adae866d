"""Plain reference of the fused wow/flutter restoration that the benchmark
judges the program against.

From a take (the benchmark's own input) it works out again what the
program's fused entries derive: the speed curve (banded DFT tracking,
masked peak, parabolic refinement), its centring on the exact quantized
mean, the dithered position plan and the windowed-sinc resample.  It is
plain PyTorch and NumPy and imports nothing of the program.

Where the restoration's semantics are float32 (the tracking product, the
log speeds, the quantized centring, the speeds and the dithered counts)
the reference computes in float32 in the same order, because the plan
turns a one-ulp change of a speed into a different dither rounding.
Where the program only approximates an exact value (the integer and
fraction cumsums of the plan, the segment advances, the output positions
and the sinc sums) the reference computes the exact value in float64.

The centring mean is a float32 value whose last bit a one-ulp change of a
tracked peak can flip, and one ulp of it scales the whole curve by ~3e-7:
so the reference keeps three candidate curves, the mean rounded to
nearest and its two float32 neighbours, and the comparison judges the
program against the candidate whose plan its output follows.

``tf32_in`` gives a control: the operands of the products of the stages
it names ("track", the tracking's banded DFT; "sinc", the resample's
taps) rounded to TF32 (10 mantissa bits) and accumulated in float32, as
a card computes a float32 product with TF32 on.  The reference's own
products are true float32 (TF32 off) whatever the process has set.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _dsp

CHUNK_FRAMES = 4096  # frames a tracking product, as the program's
SINC_BLOCK = {"cuda": 1 << 26, "cpu": 1 << 21}  # taps in a block of the float64 sinc


def tf32(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    even, kept in float32."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x0FFF + ((u >> 13) & 1)) & ~0x1FFF
    return u.to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def true_float32():
    """Float32 matrix products without TF32 on a card, restoring the
    process's setting after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _f32(v: float) -> float:
    return float(np.float32(v))


def reflect_pad(x, pad: int):
    """numpy's ``mode="reflect"`` over the last axis (edge not repeated)."""
    n = x.shape[-1]
    i = torch.arange(-pad, n + pad, device=x.device)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return x[..., torch.where(i >= n, period - i, i)]


def banded_dft(n_fft: int, zeropad: int, lo: int, hi: int):
    """(n_fft, 2 (hi - lo)) real DFT matrix of rFFT bins [lo, hi) of the
    zero-padded transform, cos then sin columns, scaled by 1/sqrt(n_fft)."""
    ang = -2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(lo, hi)) / (n_fft * zeropad)
    scale = 1.0 / np.sqrt(n_fft)
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32) * scale


def peak_refine(mag, nl, nu, bin_offset: float):
    """Per frame: the first argmax inside [nl, nu), refined by a parabola
    through its neighbours where it is strictly above both, else the bin."""
    F_ = mag.shape[-1]
    bins = torch.arange(F_, device=mag.device)
    inside = (bins >= nl[:, None]) & (bins < nu[:, None])
    peak = torch.argmax(torch.where(inside, mag, -torch.inf), dim=-1)
    p = torch.clamp(peak, 1, F_ - 2)
    a = torch.gather(mag, -1, (p - 1)[:, None])[:, 0]
    b = torch.gather(mag, -1, p[:, None])[:, 0]
    c = torch.gather(mag, -1, (p + 1)[:, None])[:, 0]
    denom = a - 2 * b + c
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-12), denom)
    xv = 0.5 * (a - c) / denom + p
    out = torch.where((a < b) & (b > c) & (peak == p), xv, peak.to(xv.dtype))
    return out + bin_offset if bin_offset else out


def track(mono, NL: int, NU: int, band, p: dict, tf32_products: bool = False):
    """Refined peak bin (float32) of every frame of the reflect-centred
    take ``mono`` (n,) float32 tensor."""
    n_fft, step, zeropad = p["fft_size"], p["hop"], p["zeropad"]
    xp = reflect_pad(mono, n_fft // 2)
    n_frames = (xp.shape[0] - n_fft) // step + 1
    ratio = n_fft // step
    n_chunks = -(-n_frames // CHUNK_FRAMES)
    span = (CHUNK_FRAMES + ratio - 1) * step
    xp = F.pad(xp, (0, max(0, n_chunks * CHUNK_FRAMES * step + span - xp.shape[0])))
    num_bins = n_fft * zeropad // 2 + 1
    lo, hi = max(0, int(band[0])), min(num_bins, int(band[1]))
    nb = hi - lo
    dev = mono.device
    dft = torch.as_tensor(banded_dft(n_fft, zeropad, lo, hi), dtype=torch.float32, device=dev)
    window = torch.as_tensor(_dsp.get_window(p["window"], n_fft, fftbins=True)
                             .astype(np.float32), device=dev)
    if tf32_products:
        dft = tf32(dft)
    pad_t = n_chunks * CHUNK_FRAMES - n_frames
    nl = F.pad(torch.full((n_frames,), NL, dtype=torch.int32, device=dev), (0, pad_t),
               value=lo + 1)
    nu = F.pad(torch.full((n_frames,), NU, dtype=torch.int32, device=dev), (0, pad_t),
               value=lo + 2)
    out = []
    for c in range(n_chunks):
        a = c * CHUNK_FRAMES * step
        frames = xp[a:a + span].unfold(-1, n_fft, step)[:CHUNK_FRAMES] * window
        if tf32_products:
            frames = tf32(frames)
        with true_float32():
            ri = torch.matmul(frames, dft)
        mag = torch.sqrt(ri[:, :nb] ** 2 + ri[:, nb:] ** 2) + 1e-7
        sl = slice(c * CHUNK_FRAMES, (c + 1) * CHUNK_FRAMES)
        out.append(peak_refine(mag, nl[sl] - lo, nu[sl] - lo, float(lo)))
    return torch.cat(out)[:n_frames]


def log2_speeds(refined):
    """float64 log2 of the refined bins: the float32 log times the float32
    1/ln 2, the product exact."""
    f64 = torch.float64
    ls = torch.log(torch.clamp(refined, min=1.0).to(f64)).to(torch.float32).to(f64)
    return ls * _f32(1.0 / math.log(2.0))


def centre_candidates(ls, band):
    """The three candidate float32 centring means (module docstring): the
    exact mean of the quantized log speeds ``round((ls - c) 2**16)``,
    rounded to float32, and its two neighbours."""
    center = _f32(math.log2(max((band[0] + band[1]) / 2.0, 2.0)))
    q = torch.round((ls - center).to(torch.float32) * 65536.0).to(torch.int64)
    total, count = int(q.sum()), int(q.numel())
    m0 = np.float32(center + total / (65536.0 * count))
    return [np.nextafter(m0, np.float32(-np.inf)), m0, np.nextafter(m0, np.float32(np.inf))]


def speeds_for(ls, mean) -> torch.Tensor:
    """float32 speeds ``2 ** (ls - mean)``, the centring rounded once."""
    f64 = torch.float64
    centred = (ls - float(mean)).to(torch.float32)
    return torch.pow(2.0, centred.to(f64)).to(torch.float32)


def plan(speeds, step: int, max_n: int, drift: int) -> dict:
    """The dithered position plan of a float32 speed curve (F,): the
    clipped curve, the output counts ``n`` (F - 1,) int64, and each
    segment's exact input advance and base position (float64)."""
    d = min(0.9, max(drift - 2, 1) / max_n)
    s = torch.clamp(speeds, min=_f32(1.0 / (1.0 + d)), max=_f32(1.0 / (1.0 - d)))
    s_lo, s_hi = s[:-1], s[1:]
    n_raw = (step * (s_lo + s_hi) / 2.0).to(torch.float64)  # float32 sums, exact after
    rounded = torch.floor(torch.cumsum(n_raw, 0) + 0.5).to(torch.int64)
    n = torch.clamp(torch.diff(rounded, prepend=torch.zeros_like(rounded[:1])), 0, max_n)
    lo64, hi64 = s_lo.to(torch.float64), s_hi.to(torch.float64)
    adv = torch.cat([
        _inv_grid(lo64[a:a + 4096], hi64[a:a + 4096], n[a:a + 4096], max_n)[0].sum(1)
        for a in range(0, n.shape[0], 4096)]) if n.shape[0] else n.to(torch.float64)
    base = torch.cumsum(adv, 0) - adv
    return {"s_lo": lo64, "s_hi": hi64, "n": n, "base": base, "max_n": max_n}


def _inv_grid(lo, hi, n, max_n: int):
    """(rows, max_n) float64 reciprocal speeds of each row's lerped block
    speeds, zero past the row's count."""
    k = torch.arange(max_n, dtype=torch.float64, device=lo.device)[None, :]
    denom = torch.clamp(n - 1, min=1).to(torch.float64)[:, None]
    bs = lo[:, None] + k / denom * (hi - lo)[:, None]
    return torch.where(k < n[:, None], 1.0 / bs, 0.0), bs


def sinc_rows(x, pl: dict, a: int, b: int, nt: int, tf32_products: bool = False,
              slope: bool = False):
    """Rows [a, b) of the resample of ``x`` (n,) float64 through the plan
    ``pl``: (b - a, max_n), zero past each row's count.  Output k of row i
    sits at ``base_i + sum_{m <= k} 1/bs_m``; its value is the Hann-tapered
    windowed sinc over the 2 nt input samples from ``round(pos) - nt``, cut
    off at ``min(bs, 1)``, reading zero outside the take.  ``slope=True``
    gives instead the derivative of each value by its position."""
    max_n = pl["max_n"]
    inv, bs = _inv_grid(pl["s_lo"][a:b], pl["s_hi"][a:b], pl["n"][a:b], max_n)
    valid = inv > 0
    pos = pl["base"][a:b, None] + torch.cumsum(inv, 1)
    anchor = torch.round(pos)
    shift = pos - anchor
    fc = torch.clamp(bs, max=1.0)[..., None]
    j = torch.arange(-nt, nt, dtype=torch.float64, device=x.device)
    idx = anchor.to(torch.int64)[..., None] + j.to(torch.int64)
    inside = (idx >= 0) & (idx < x.shape[0])
    xv = torch.where(inside, x[idx.clamp(0, x.shape[0] - 1)], 0.0)
    hann = 0.5 - 0.5 * torch.cos(math.pi * (j + nt) / nt)
    z = (j - shift[..., None]) * fc
    if slope:  # d sinc(z)/dz = (cos(pi z) - sinc(z)) / z, and dz/dpos = -fc
        safe = torch.where(z == 0, 1.0, z)
        dsinc = torch.where(z == 0, 0.0, (torch.cos(math.pi * z) - torch.sinc(z)) / safe)
        return torch.where(valid, (xv * (-fc * fc * hann * dsinc)).sum(-1), 0.0)
    w = torch.sinc(z) * fc * hann
    if tf32_products:
        out = (tf32(xv.to(torch.float32)) * tf32(w.to(torch.float32))).sum(-1)
        return torch.where(valid, out, 0.0).to(torch.float64)
    return torch.where(valid, (xv * w).sum(-1), 0.0)


class Reference:
    """The reference of one take ``x`` (C, n) float32 (host numpy):
    tracking on channel 0, the three candidate plans (module docstring),
    and the resample of every channel through a chosen candidate's plan,
    computed on ``device`` in blocks of rows."""

    def __init__(self, x, params: dict, device, tf32_in: tuple = ()):
        self.params = params
        self.tf32 = "sinc" in tf32_in
        self.x = torch.as_tensor(np.ascontiguousarray(x), device=device)
        self.streams = {}
        p = params
        refined = track(self.x[0], p["NL"], p["NU"], p["band"], p, "track" in tf32_in)
        ls = log2_speeds(refined)
        self.plans = [plan(speeds_for(ls, m), p["hop"], p["max_n"], p["drift"])
                      for m in centre_candidates(ls, p["band"])]

    def counts(self, cand: int = 1) -> np.ndarray:
        return self.plans[cand]["n"].cpu().numpy()

    def grid(self, cand: int = 1, ch: int = 0, slope: bool = False):
        """(T, max_n) float64 resampled grid of channel ``ch`` (a tensor),
        or with ``slope=True`` each value's derivative by its position."""
        pl = self.plans[cand]
        x = self.x[ch].to(torch.float64)
        T, nt = pl["n"].shape[0], self.params["nt"]
        rows = max(1, SINC_BLOCK[x.device.type] // (2 * nt * pl["max_n"]))
        return torch.cat([sinc_rows(x, pl, a, min(a + rows, T), nt, self.tf32, slope)
                          for a in range(0, T, rows)]) if T else torch.zeros(
            (0, pl["max_n"]), dtype=torch.float64, device=x.device)

    def stream(self, cand: int, ch: int, slope: bool = False) -> np.ndarray:
        """The compacted (sum n,) float64 output of channel ``ch`` (or its
        slope, as :meth:`grid`), worked out once."""
        key = (cand, ch, slope)
        if key not in self.streams:
            g = self.grid(cand, ch, slope)
            k = torch.arange(g.shape[1], device=g.device)[None, :]
            self.streams[key] = g[k < self.plans[cand]["n"][:, None]].cpu().numpy()
        return self.streams[key]

    def program_grids(self) -> np.ndarray:
        """(C, T, max_n) float32 grids through the nearest candidate: what
        the reference gives in the program's place (a control)."""
        return np.stack([self.grid(1, c).to(torch.float32).cpu().numpy()
                         for c in range(self.x.shape[0])])
