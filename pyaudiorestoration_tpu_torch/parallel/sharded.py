"""Host helpers of the sharded tier (pyaudiorestoration_tpu/parallel/
sharded.py), copied bit for bit because that module imports JAX.

The mesh functions themselves (``restore_fused_sharded`` and the rest) are
not ported yet; on one card ``parallel.batch`` runs the batch through
``restore_fused_takes``, whose rows equal the solo restores as the sharded
tier's do.
"""

from __future__ import annotations

import numpy as np

__all__ = ["unwrap_base_int", "compact_padded_host"]


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
