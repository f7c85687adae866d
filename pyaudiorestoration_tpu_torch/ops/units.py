"""Unit conversions and formatting (counterpart of
pyaudiorestoration_tpu/ops/units.py; reference: util/units.py:4-62).

The conversions work on host numpy arrays and on torch tensors alike: a
tensor stays on its device.
"""

from __future__ import annotations

import numpy as np
import torch


def _xp(a):
    return torch if isinstance(a, torch.Tensor) else np


def to_dB(a):
    return 20 * _xp(a).log10(a)


def to_fac(a):
    if isinstance(a, torch.Tensor):
        return torch.pow(10, a / 20)
    return np.power(10, a / 20)


def to_mel(val):
    return _xp(val).log(val / 700 + 1) * 1127


def to_Hz(val):
    return (_xp(val).exp(val / 1127) - 1) * 700


def normalize(d, copy=False):
    """Peak-normalize to |max| == 1 (units.py:32-40).  A tensor is never
    changed in place."""
    xp = _xp(d)
    m = xp.max(xp.abs(d))
    if copy or xp is torch:
        return d / m
    d /= m
    return d


def sec_to_timestamp(t):
    m, s = divmod(t, 60)
    s, ms = divmod(s * 1000, 1000)
    h, m = divmod(m, 60)
    return "%d:%02d:%02d:%03d h:m:s:ms" % (h, m, s, ms)


def t_2_m_s_ms(t):
    prefix = "-" if t < 0 else ""
    t = abs(t)
    m, s = divmod(t, 60)
    s, ms = divmod(s * 1000, 1000)
    return f"{prefix}%02d:%02d\n%03d" % (m, s, ms)


A4 = 440
C0 = A4 * np.power(2, -4.75)
note_names = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


def pitch(freq):
    """Nearest note name for a frequency, e.g. 440 -> 'A4' (units.py:55-62)."""
    if freq > 0:
        h = round(12 * np.log2(freq / C0))
        octave = int(h // 12)
        n = int(h % 12)
        if -1 < octave < 10:
            return note_names[n] + str(octave)
    return "-"
