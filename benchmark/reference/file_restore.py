"""Plain reference of ``respeed --fast`` file to file, the path whose
output file the ``file_fast`` pipeline judges.

The take is the one the input file holds (its 24-bit integers over 2**23).
The pilot-tone probe, the band, the tracking and the three candidate
centrings are those of :mod:`benchmark.reference.restore`, because the file
path tracks with the same ``track_speed_device`` as the fused entries.
What differs is the plan, which the file path makes on the host in
float64 (:func:`file_plan`):

- each segment's raw count ``hop (s_lo + s_hi) / 2`` in float64 from the
  float32 speeds, with no clip of the curve;
- the counts as the differences of the rounded float64 cumsum of the raw
  counts, rounded half to even as numpy rounds (the raw counts are exact
  multiples of 2**-16 well inside float64's range, so the cumsum is exact
  and a tie can occur);
- each segment's input advance as the exact float64 sum of ``1 / speed``
  over its grid of lerped speeds;
- the end trim: the stream stops before the output position nearest the
  input's end, in the first segment whose end reaches it.

The resample is the same exact float64 windowed sinc, and the answer is
the compacted stream of ``n_out`` samples a channel.  Plain PyTorch and
NumPy; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import restore


def file_plan(speeds, hop: int, n_in: int) -> dict:
    """The file path's position plan of a float32 speed curve (F,) for a
    take of ``n_in`` samples: :func:`benchmark.reference.restore.plan`'s
    dict of the unclipped curve, whose counts ``n`` the resample computes,
    and ``n_out``, the stream's length after the end trim."""
    f64 = torch.float64
    lo, hi = speeds[:-1].to(f64), speeds[1:].to(f64)
    n_raw = hop * (lo + hi) / 2.0
    rounded = torch.round(torch.cumsum(n_raw, 0))
    n = torch.clamp(torch.diff(rounded, prepend=torch.zeros_like(rounded[:1])),
                    min=0).to(torch.int64)
    max_n = int(n.max()) if n.numel() else 0
    adv = torch.cat([
        restore._inv_grid(lo[a:a + 4096], hi[a:a + 4096], n[a:a + 4096], max_n)[0].sum(1)
        for a in range(0, n.shape[0], 4096)]) if n.numel() else lo
    base = F.pad(torch.cumsum(adv, 0)[:-1], (1, 0))
    n_out = int(n.sum())
    over = torch.nonzero(base + adv >= n_in)
    if over.numel():
        i = int(over[0, 0])
        inv = restore._inv_grid(lo[i:i + 1], hi[i:i + 1], n[i:i + 1].clamp(min=1),
                                max(1, int(n[i])))[0][0]
        pos = (float(base[i]) + torch.cumsum(inv, 0)).cpu().numpy()
        n_out = int(n[:i].sum()) + int(np.argmin(np.abs(pos - n_in)))
    return {"s_lo": lo, "s_hi": hi, "n": n, "n_out": n_out, "base": base, "max_n": max_n}


class FileReference(restore.Reference):
    """The reference of one take ``x`` (C, n) float32 (host numpy) through
    the file path: tracking on channel 0, the three candidate plans of
    :func:`file_plan`, and each channel's trimmed stream through a chosen
    candidate (:meth:`stream`)."""

    def __init__(self, x, params: dict, device, tf32_in: tuple = ()):
        self.params = params
        self.tf32 = "sinc" in tf32_in
        self.x = torch.as_tensor(np.ascontiguousarray(x), device=device)
        self.streams = {}
        p = params
        refined = restore.track(self.x[0], p["NL"], p["NU"], p["band"], p, "track" in tf32_in)
        ls = restore.log2_speeds(refined)
        self.plans = [file_plan(restore.speeds_for(ls, m), p["hop"], self.x.shape[1])
                      for m in restore.centre_candidates(ls, p["band"])]

    def stream(self, cand: int, ch: int, slope: bool = False) -> np.ndarray:
        """The (n_out,) float64 stream of channel ``ch`` (or its slope): the
        compacted resample of :class:`~benchmark.reference.restore.Reference`
        up to the end trim."""
        return super().stream(cand, ch, slope)[:self.plans[cand]["n_out"]]

    def program_stream(self) -> np.ndarray:
        """(C, n_out) float32 stream through the nearest candidate: what the
        reference writes in the program's place (a control)."""
        return np.stack([self.stream(1, c).astype(np.float32) for c in range(self.x.shape[0])])
