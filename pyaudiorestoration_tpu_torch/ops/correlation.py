"""Sub-sample peak refinement (counterpart of pyaudiorestoration_tpu/ops/correlation.py).

Only ``parabolic_batch`` is on the wow/flutter slice; the correlation
estimators are still to be ported.
"""

from __future__ import annotations

import torch

__all__ = ["parabolic_batch"]


def parabolic_batch(f: torch.Tensor, x: torch.Tensor):
    """Quadratic-interpolate the peak of ``f`` (..., n) at integer indices
    ``x`` (...).  Returns (refined_index, refined_value) (correlation.py:42-46)."""
    fm1 = torch.gather(f, -1, (x - 1).unsqueeze(-1)).squeeze(-1)
    f0 = torch.gather(f, -1, x.unsqueeze(-1)).squeeze(-1)
    fp1 = torch.gather(f, -1, (x + 1).unsqueeze(-1)).squeeze(-1)
    denom = fm1 - 2 * f0 + fp1
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-12), denom)
    xv = 0.5 * (fm1 - fp1) / denom + x
    yv = f0 - 0.25 * (fm1 - fp1) * (xv - x)
    return xv, yv
