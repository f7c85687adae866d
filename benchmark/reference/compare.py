"""The comparison that decides ``correct``: a padded grid that the timed
entry returned against the plain reference of the same take.

The grid holds each segment's samples followed by zeros, so the counts
that the program's plan gave each segment are read from it: the last
nonzero sample of a row ends the row.  A real sample can be exactly zero,
as the rows past the take's end are; a row that reads short is taken as a
dither flip only beside a row that reads long (a flip moves one sample
between neighbours), and otherwise as a row whose last samples are zero.

With those counts the grid is compacted into the stream that a user's file
holds and set beside the reference's stream, sample by sample.  The
program's float32 plan puts each output a few thousandths of an input
sample off the exact position, so the streams are compared in two parts
(:func:`aligned_gaps`): the timing, an input-position offset a segment,
and the residual that no such offset explains, the resample's values.  A
cell's limits file names the numbers it compares: a wrong curve, centring
or plan moves the timing; a lost, stale or altered answer the widest
residual; and products of a lower precision in the resample the residual's
root mean square, which they raise on every sample.
"""

from __future__ import annotations

import numpy as np

NUMBERS = ("sample_gap", "residual_gap", "residual_rms", "timing_gap")


def counts_from_grid(grid, n_ref):
    """Per-row output counts of a (C, T, max_n) or (T, max_n) grid, read as
    the module docstring says, against the reference's counts ``n_ref``."""
    nz = np.asarray(grid) != 0
    if nz.ndim == 3:
        nz = nz.any(axis=0)
    max_n = nz.shape[1]
    n_g = np.where(nz.any(axis=1), max_n - np.argmax(nz[:, ::-1], axis=1), 0)
    n_ref = np.asarray(n_ref, np.int64)
    extra = n_g > n_ref
    beside = np.zeros_like(extra)
    beside[1:] |= extra[:-1]
    beside[:-1] |= extra[1:]
    return np.where((n_g < n_ref) & ~beside, n_ref, n_g)


def compact(grid_ch, counts):
    """(T, max_n) grid of one channel -> its compacted stream."""
    k = np.arange(grid_ch.shape[1])[None, :]
    return np.asarray(grid_ch)[k < np.asarray(counts)[:, None]]


def stream_gap(a, b) -> tuple:
    """(widest sample gap of two streams, where it lies as a share of the
    longer stream); samples one has and the other has not count at their
    full value."""
    m = min(len(a), len(b))
    d = np.abs(np.concatenate([a[:m].astype(np.float64) - b[:m], a[m:], b[m:]]))
    if not len(d):
        return 0.0, 0.0
    i = int(np.argmax(d))
    return float(d[i]), i / len(d)


def aligned_gaps(ps, rs, slopes, counts) -> tuple:
    """(widest residual, root mean square residual, widest timing offset)
    of program streams ``ps``
    against reference streams ``rs`` with their slopes by input position
    ``slopes`` (one per channel, equal lengths).

    Each segment's gap is first explained, by least squares on the
    reference's slope jointly over the channels, as an input-position
    offset that runs linearly across the segment: the timing error that a
    float32 plan's positions carry (its base fraction and its in-row
    cumsum).  The residual is what that cannot explain, the resample's
    values; the offsets, in input samples, are the curve's and the plan's
    timing."""
    counts = np.asarray(counts, np.int64)
    L = len(rs[0])
    ends = np.minimum(np.cumsum(counts), L)
    starts = np.minimum(np.cumsum(counts) - counts, L)
    keep = ends > starts
    starts, ends = starts[keep], ends[keep]
    if not len(starts):
        return 0.0, 0.0, 0.0
    seg = np.repeat(np.arange(len(starts)), ends - starts)
    t = (np.arange(L) - starts[seg]) / np.maximum(ends - starts, 1)[seg]
    s11 = s12 = s22 = y1 = y2 = 0.0
    for p, r, dr in zip(ps, rs, slopes):
        d = p - r
        s11 = s11 + np.add.reduceat(dr * dr, starts)
        s12 = s12 + np.add.reduceat(dr * dr * t, starts)
        s22 = s22 + np.add.reduceat(dr * dr * t * t, starts)
        y1 = y1 + np.add.reduceat(d * dr, starts)
        y2 = y2 + np.add.reduceat(d * dr * t, starts)
    det = s11 * s22 - s12 * s12
    ok = det > 1e-9 * np.maximum(s11 * s22, 1e-300)
    det = np.where(ok, det, 1.0)
    a = np.where(ok, (y1 * s22 - y2 * s12) / det, 0.0)
    b = np.where(ok, (s11 * y2 - s12 * y1) / det, 0.0)
    offset = a[seg] + b[seg] * t
    resid, sq = 0.0, 0.0
    for p, r, dr in zip(ps, rs, slopes):
        e = p - r - offset * dr
        resid = max(resid, float(np.max(np.abs(e), initial=0.0)))
        sq += float(np.dot(e, e))
    rms = (sq / (L * len(ps))) ** 0.5 if L else 0.0
    return resid, rms, float(np.max(np.abs(offset), initial=0.0))


def judge(grid, ref) -> dict:
    """The numbers of a program grid (C, T, max_n) against a
    :class:`~benchmark.reference.restore.Reference` of the same take:

    - ``sample_gap``: the widest gap of the compacted streams;
    - ``residual_gap``: the widest gap once each segment is aligned by its
      best input-position offset (:func:`aligned_gaps`): the resample's
      values, whatever small timing error the plan's float32 positions
      carry;
    - ``residual_rms``: the root mean square of that aligned gap over every
      sample of every channel;
    - ``timing_gap``: the widest of those offsets, in input samples: the
      curve and the plan;

    and what was read on the way: where the widest gap lies, the candidate
    centring followed (-1, 0, +1), the dither flips and the rows read
    short for zero samples.  The aligned numbers compare the streams over
    their common length; samples past it count at full value where the
    streams differ by more than the one sample of a last dither."""
    grid = np.asarray(grid)
    if grid.ndim == 2:
        grid = grid[None]
    C, T = grid.shape[:2]
    best = None
    scores = []
    for cand in range(len(ref.plans)):
        n_ref = ref.counts(cand)
        if len(n_ref) != T:
            return {"sample_gap": float("inf"), "residual_gap": float("inf"),
                    "residual_rms": float("inf"), "timing_gap": float("inf"),
                    "rows": int(T), "rows_ref": len(n_ref)}
        n_p = counts_from_grid(grid, n_ref)
        scores.append(int(np.max(np.abs(np.cumsum(n_p) - np.cumsum(n_ref)), initial=0)))
    low = min(scores)
    for cand in [c for c, s in enumerate(scores) if s == low]:
        n_ref = ref.counts(cand)
        n_p = counts_from_grid(grid, n_ref)
        ps = [compact(grid[c], n_p) for c in range(C)]
        rs = [ref.stream(cand, c) for c in range(C)]
        gap, at = max(stream_gap(p, r) for p, r in zip(ps, rs))
        if best is not None and gap >= best["sample_gap"]:
            continue
        m = min(len(ps[0]), len(rs[0]))
        resid, rms, timing = aligned_gaps([p[:m] for p in ps], [r[:m] for r in rs],
                                     [ref.stream(cand, c, slope=True)[:m] for c in range(C)],
                                     n_p)
        if abs(len(ps[0]) - len(rs[0])) > 1:  # more than the last dither apart
            resid = max(resid, *(float(np.max(np.abs(np.concatenate([p[m:], r[m:]])),
                                              initial=0.0)) for p, r in zip(ps, rs)))
        nz = (grid != 0).any(axis=0)
        n_g = np.where(nz.any(axis=1), grid.shape[2] - np.argmax(nz[:, ::-1], axis=1), 0)
        best = {"sample_gap": gap, "residual_gap": resid, "residual_rms": rms,
                "timing_gap": timing,
                "at": round(at, 6), "centring": cand - 1, "flips": int(np.sum(n_p != n_ref)),
                "zero_ends": int(np.sum(n_p != n_g))}
    return best
