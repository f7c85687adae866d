"""Headless marker model + master-curve assembly (counterpart of
pyaudiorestoration_tpu/models/markers.py, host numpy and scipy only).

Reference: util/markers.py — there, markers are vispy visuals entangled with
the canvas; here they are plain data objects with the same serialized form
(``to_cfg``/``from_cfg``), and the master curves are pure functions of marker
lists plus a (sr, hop, duration) grid.

Curve math runs on the host in float64 (frame-rate sized control-plane data);
the heavy per-sample work happens downstream in the ops layer.  The
band-pass is the port's ``filters`` host backend (scipy), so every curve is
bit-equal to the JAX package's.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.interpolate
import scipy.ndimage

from ..ops import filters
from .trackers import interp_nans, nan_helper

__all__ = [
    "TraceLine", "RegLine", "LagSample", "AzimuthLine", "DropoutSample",
    "PanSample", "MasterSpeedLine", "MasterRegLine", "LagLine", "PanLine",
    "sample_lines",
]


def sample_lines(times, lines_times, lines_values):
    """Lerp every line onto ``times`` (NaN outside its span) and nanmean
    (markers.py:607-615)."""
    out = np.full((len(times), len(lines_times)), np.nan, dtype=np.float64)
    for i, (lt, lv) in enumerate(zip(lines_times, lines_values)):
        out[:, i] = np.interp(times, lt, lv, left=np.nan, right=np.nan)
    if out.shape[1] == 0:
        return np.full(len(times), np.nan)
    import warnings

    with warnings.catch_warnings():
        # all-NaN rows (gaps between traces) are expected; interp_nans fills them
        warnings.simplefilter("ignore", category=RuntimeWarning)
        return np.nanmean(out, axis=1)


class TraceLine:
    """A traced speed fragment: log2 freqs centered on 0 plus an offset
    (markers.py:179-277)."""

    def __init__(self, times, freqs, offset=None, auto_align=False, other_lines=()):
        self.times = np.asarray(times, dtype=np.float64)
        self.freqs = np.asarray(freqs, dtype=np.float64)
        self.speed = np.log2(self.freqs)
        self.speed -= np.mean(self.speed)
        if offset is None:
            if not auto_align or not other_lines:
                offset = 0.0
            else:
                sampled = sample_lines(self.times,
                                       [l.times for l in other_lines],
                                       [l.speed for l in other_lines])
                offset = np.nanmean(sampled - self.speed)
                offset = 0.0 if np.isnan(offset) else float(offset)
        self.offset = float(offset)
        self.speed = self.speed + self.offset
        self.spec_center = np.array((np.mean(self.times), np.mean(self.freqs)))
        self.speed_center = np.array((np.mean(self.times), np.mean(self.speed)))

    @property
    def start(self):
        return self.times[0]

    @property
    def end(self):
        return self.times[-1]

    def to_cfg(self):
        return list(self.times), list(self.freqs), self.offset

    @classmethod
    def from_cfg(cls, times, freqs, offset):
        return cls(times, freqs, offset=offset)


class RegLine:
    """A sine-regression segment (markers.py:91-177)."""

    def __init__(self, t0, t1, amplitude, omega, phase, offset):
        self.t0 = float(t0)
        self.t1 = float(t1)
        self.t_center = (self.t0 + self.t1) / 2
        # amplitude/phase normalization so interpolation works (markers.py:119-122)
        if amplitude < 0:
            amplitude *= -1
            phase += np.pi
        self.amplitude = float(amplitude)
        self.omega = float(omega)
        self.phase = float(phase)
        self.offset = float(offset)

    def speed_at(self, times):
        return self.amplitude * np.sin(self.omega * np.asarray(times) + self.phase)

    def to_cfg(self):
        return self.t0, self.t1, self.amplitude, self.omega, self.phase, self.offset

    @classmethod
    def from_cfg(cls, *args):
        return cls(*args)


@dataclass
class LagSample:
    """A sub-sample alignment marker between two sources (markers.py:429-483)."""

    a: tuple
    b: tuple
    d: float = 0.0
    corr: float = 0.0

    def __post_init__(self):
        self.t = (self.a[0] + self.b[0]) / 2
        self.f = (self.a[1] + self.b[1]) / 2
        self.width = abs(self.a[0] - self.b[0])
        self.height = abs(self.a[1] - self.b[1])

    def to_cfg(self):
        return self.a[0], self.a[1], self.b[0], self.b[1], self.d, self.corr

    @classmethod
    def from_cfg(cls, a0, a1, b0, b1, d, corr=0.0):
        return cls((a0, a1), (b0, b1), d, corr)


class AzimuthLine:
    """Per-window lag sweep over a band, with correlation-based rejection
    (markers.py:486-563)."""

    def __init__(self, times, lags, corrs, lower, upper):
        self.times = np.asarray(times, dtype=np.float64)
        self.lags_raw = np.asarray(lags, dtype=np.float64)
        self.lags = np.array(self.lags_raw)
        self.corrs = np.asarray(corrs, dtype=np.float64)
        self.lower = float(lower)
        self.upper = float(upper)
        self.d = float(np.mean(self.lags))
        self.corr = float(np.mean(self.corrs))

    @property
    def t(self):
        return (self.times[0] + self.times[-1]) / 2

    def update_reject(self, overlap, reject):
        """Reject weakly-correlated windows, lerp over them, median-filter
        outliers (markers.py:542-554)."""
        self.lags = np.array(self.lags_raw)
        self.lags[np.abs(self.corrs) < reject] = np.nan
        interp_nans(self.lags)
        self.lags = scipy.ndimage.median_filter(
            self.lags, size=filters.make_odd(int(overlap)), mode="nearest")
        self.d = float(np.mean(self.lags))

    def to_cfg(self):
        return list(self.times), list(self.lags), list(self.corrs), self.lower, self.upper

    @classmethod
    def from_cfg(cls, times, lags, corrs, lower, upper):
        return cls(times, lags, corrs, lower, upper)


@dataclass
class DropoutSample:
    """A time-frequency dropout box (markers.py:366-426)."""

    a: tuple
    b: tuple
    surrounding: float = 0.5

    def __post_init__(self):
        self.t = (self.a[0] + self.b[0]) / 2
        self.f = (self.a[1] + self.b[1]) / 2
        self.width = abs(self.a[0] - self.b[0])
        self.height = abs(self.a[1] - self.b[1])

    def to_cfg(self):
        return self.a[0], self.a[1], self.b[0], self.b[1], self.surrounding

    @classmethod
    def from_cfg(cls, a0, a1, b0, b1, surrounding=0.5, *extra):
        return cls((a0, a1), (b0, b1), surrounding)


@dataclass
class PanSample:
    """A time-frequency box with an L/R energy ratio (markers.py:325-363)."""

    a: tuple
    b: tuple
    pan: float = 1.0

    def __post_init__(self):
        self.t = (self.a[0] + self.b[0]) / 2
        self.f = (self.a[1] + self.b[1]) / 2

    def to_cfg(self):
        return self.a[0], self.a[1], self.b[0], self.b[1], self.pan

    @classmethod
    def from_cfg(cls, a0, a1, b0, b1, pan):
        return cls((a0, a1), (b0, b1), pan)


# ---------------------------------------------------------------------------
# Master curves
# ---------------------------------------------------------------------------

class _CurveGrid:
    def __init__(self, sr, hop, duration, bands=(0, 9999999)):
        self.sr = sr
        self.hop = hop
        self.duration = duration
        self.bands = bands

    @property
    def marker_sr(self):
        return self.sr / self.hop

    def get_times(self):
        num = int(self.duration * self.marker_sr)
        return np.linspace(0, self.duration, num=num)

    def filter_bandpass(self, samples):
        lowcut, highcut = sorted(self.bands)
        # host on purpose: the master curve is frame-rate (sr/hop, a few
        # hundred points per minute of audio) and updated interactively; a
        # device dispatch + transfer costs more than scipy's f64 cascade
        # and the reference's curve is bit-matched by the f64 path
        # (markers.py:601-605).
        return np.asarray(filters.butter_bandpass_filter(
            samples, lowcut, highcut, self.marker_sr, order=3, backend="host"))


class MasterSpeedLine(_CurveGrid):
    """nanmean of overlapping traces + NaN interp + bandpass
    (markers.py:625-667). ``data`` is (n, 2): time, log2-speed."""

    def update(self, lines):
        if lines:
            times = self.get_times()
            mean = sample_lines(times, [l.times for l in lines], [l.speed for l in lines])
            interp_nans(mean)
            self.data = np.stack((times, self.filter_bandpass(mean)), axis=-1)
        else:
            self.data = np.zeros((2, 2))
            self.data[:, 0] = (0, 999)
        return self.data

    def get_linspace(self, lines=None):
        """log2 speed curve -> linear speed factors (markers.py:595-599)."""
        if lines is not None:
            self.update(lines)
        out = np.array(self.data)
        out[:, 1] = np.power(2, out[:, 1])
        return out

    @staticmethod
    def get_overlapping_lines(lines):
        """Group traces into overlapping clusters (markers.py:641-664)."""
        if not lines:
            return []
        sorted_lines = sorted(lines, key=lambda l: l.start)
        merged = [[sorted_lines[0]]]
        for higher in sorted_lines[1:]:
            group = merged[-1]
            upper_bound = max(l.end for l in group)
            if higher.start <= upper_bound:
                group.append(higher)
            else:
                merged.append([higher])
        return merged


class MasterRegLine(_CurveGrid):
    """Phase-continuous blending of sine regressions (markers.py:670-708)."""

    def update(self, regs):
        if regs:
            times = self.get_times()
            regs = sorted(regs, key=lambda r: r.t_center)
            pi2 = 2 * np.pi
            t_centers, amp_centers, phi_centers = [], [], []
            for i, reg in enumerate(regs):
                if i == 0:
                    phi_centers.append(reg.omega * times[0] + reg.phase % pi2 + reg.offset * pi2)
                    t_centers.append(times[0])
                    amp_centers.append(reg.amplitude)
                phi_centers.append(reg.omega * reg.t_center + reg.phase % pi2 + reg.offset * pi2)
                t_centers.append(reg.t_center)
                amp_centers.append(reg.amplitude)
                if i == len(regs) - 1:
                    phi_centers.append(reg.omega * times[-1] + reg.phase % pi2 + reg.offset * pi2)
                    t_centers.append(times[-1])
                    amp_centers.append(reg.amplitude)
            sine = np.sin(np.interp(times, t_centers, phi_centers))
            amp = np.interp(times, t_centers, amp_centers)
            self.data = np.stack((times, 1.5 * amp * sine), axis=-1)
        else:
            self.data = np.zeros((2, 2))
            self.data[:, 0] = (0, 999)
        return self.data

    def get_linspace(self, regs=None):
        if regs is not None:
            self.update(regs)
        out = np.array(self.data)
        out[:, 1] = np.power(2, out[:, 1])
        return out


class LagLine(_CurveGrid):
    """Spline through lag samples with azimuth-curve overrides
    (markers.py:730-794). ``data``: (n, 2) time, lag seconds."""

    def __init__(self, sr, hop, duration, bands=(0, 9999999), smoothing=3):
        super().__init__(sr, hop, duration, bands)
        self.smoothing = smoothing

    def _interp(self, times, keys, values):
        if len(keys) == 0:
            return np.zeros(len(times))
        if len(keys) == 1:
            return np.interp(times, keys, values)
        k = min(self.smoothing, len(keys) - 1)
        spline = scipy.interpolate.InterpolatedUnivariateSpline(keys, values, k=k)
        return spline(times)

    def sample_at(self, times, lags, azimuths):
        sample_times = [s.t for s in lags]
        sample_lags = [s.d for s in lags]
        sample_corrs = [s.corr for s in lags]
        az_sampled = sample_lines(times, [a.times for a in azimuths], [a.lags for a in azimuths])
        corrs_sampled = sample_lines(times, [a.times for a in azimuths], [a.corrs for a in azimuths])
        lags_spline = self._interp(times, sample_times, sample_lags)
        corrs_spline = self._interp(times, sample_times, sample_corrs)
        nans, _ = nan_helper(az_sampled)
        az_sampled[nans] = lags_spline[nans]
        corrs_sampled[nans] = corrs_spline[nans]
        return az_sampled, corrs_sampled

    def get_times(self, lags=(), azimuths=()):
        dur = self.duration
        lag, _ = self.sample_at(np.array([dur]), lags, azimuths)
        dur = abs(dur + lag[0])
        num = int(dur * self.marker_sr)
        return np.linspace(0, dur, num=num)

    def update(self, lags, azimuths=()):
        if lags or azimuths:
            times = self.get_times(lags, azimuths)
            try:
                lag, corr = self.sample_at(times, lags, azimuths)
                lag = self.filter_bandpass(lag)
                self.data = np.stack((times, lag), axis=-1)
            except Exception:
                logging.exception("LagLine.update failed")
                self.data = np.zeros((2, 2))
        else:
            self.data = np.zeros((2, 2))
            self.data[:, 0] = (0, 999)
        return self.data


class PanLine(_CurveGrid):
    """Linear interpolation through pan samples (markers.py:711-727)."""

    def update(self, markers):
        if markers:
            markers = sorted(markers, key=lambda m: m.t)
            times = self.get_times()
            pan = np.interp(times, [m.t for m in markers], [m.pan for m in markers])
            self.data = np.stack((times, pan), axis=-1)
        else:
            self.data = np.zeros((2, 2))
            self.data[:, 0] = (0, 999)
        return self.data
