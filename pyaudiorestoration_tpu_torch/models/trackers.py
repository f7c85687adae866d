"""Peak tracking core (counterpart of pyaudiorestoration_tpu/models/trackers.py).

Only ``masked_peak_refine`` is on the wow/flutter slice; the other trackers
are still to be ported.
"""

from __future__ import annotations

import torch

from ..ops.correlation import parabolic_batch

__all__ = ["masked_peak_refine"]


def masked_peak_refine(frames: torch.Tensor, nl: torch.Tensor, nu: torch.Tensor,
                       bin_offset: float = 0.0) -> torch.Tensor:
    """Per frame, argmax within [nl, nu) (the first index on ties), parabolic
    refinement where the maximum is strictly above both neighbours, the raw
    bin otherwise (wow_detection.py:119-139).

    ``frames``: (..., T, F) magnitudes; ``nl``/``nu``: (..., T) int bands.
    Returns the refined peak bin as float32, plus ``bin_offset``."""
    F = frames.shape[-1]
    bins = torch.arange(F, device=frames.device)
    mask = (bins >= nl.unsqueeze(-1)) & (bins < nu.unsqueeze(-1))
    scores = torch.where(mask, frames, torch.full_like(frames, -torch.inf))
    peak = torch.argmax(scores, dim=-1)
    p = torch.clamp(peak, 1, F - 2)
    fm1 = torch.gather(frames, -1, (p - 1).unsqueeze(-1)).squeeze(-1)
    f0 = torch.gather(frames, -1, p.unsqueeze(-1)).squeeze(-1)
    fp1 = torch.gather(frames, -1, (p + 1).unsqueeze(-1)).squeeze(-1)
    is_peak = (fm1 < f0) & (f0 > fp1) & (peak == p)
    refined, _ = parabolic_batch(frames, p)
    out = torch.where(is_peak, refined, peak.to(refined.dtype))
    return out + bin_offset if bin_offset else out
