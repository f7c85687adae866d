"""Spectral helpers of the port (counterpart of pyaudiorestoration_tpu/ops/fourier.py).

Only the host window design is needed by the wow/flutter slice; the STFT
engine is still to be ported.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy import signal as _dsp

__all__ = ["get_window"]


@functools.lru_cache(maxsize=64)
def get_window(window_name: str, n: int, fftbins: bool = True) -> np.ndarray:
    """Host-side window design (static, cached)."""
    return _dsp.get_window(window_name, n, fftbins=fftbins).astype(np.float32)
