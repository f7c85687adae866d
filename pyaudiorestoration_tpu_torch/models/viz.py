"""Headless visualization: spectrograms with mel-frequency axes plus marker
overlays as matplotlib figures (counterpart of
pyaudiorestoration_tpu/models/viz.py; reference: util/spectrum.py,
util/vispy_ext.py, util/colormaps.py).

The reference's GUI semantics that matter for review (mel y-transform
vispy_ext.py:148-199, dB colormapping spectrum.py:15-31, marker overlays
markers.py) are reproduced as figure-producing functions for notebooks/CLI.

Each image (the dB spectrogram, its mel rows, the red/green overlay) is
made on the device and handed to matplotlib as a host array; matplotlib
only draws.  matplotlib is imported inside each function that needs it and
is not a dependency of the port: where it is missing, those functions raise
its ImportError.  The HTML viewers (``viz_html``, ``audition``) need none.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import units
from ..utils.device import as_device_tensor

__all__ = ["plot_spectrogram", "plot_speed_curves", "save_spectrogram",
           "compare_spectrograms", "save_comparison", "get_cmap",
           "apply_freq_ticks", "format_time_ticks"]

_IZO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "izo_cmap.npy")


def get_cmap(name):
    """Resolve a colormap name; registers the reference's custom "izo" table
    (colormaps.py:1047-1306, shipped as a 256x3 data asset) on first use."""
    if name != "izo":
        return name
    import matplotlib

    try:
        return matplotlib.colormaps["izo"]
    except KeyError:
        from matplotlib.colors import ListedColormap

        cmap = ListedColormap(np.load(_IZO_PATH), name="izo")
        matplotlib.colormaps.register(cmap)
        return cmap


_FREQ_TICKS = np.array([20, 50, 100, 200, 500, 1000, 2000, 5000,
                        10000, 20000, 50000, 100000], dtype=float)


def apply_freq_ticks(ax, sr, mel=True):
    """Hz-labelled ticks at the 1-2-5 positions on the (mel) frequency axis —
    the reference's log-frequency tick labeling (vispy_ext.py:216-359)."""
    ticks = _FREQ_TICKS[_FREQ_TICKS <= sr / 2]
    pos = units.to_mel(ticks) if mel else ticks
    labels = [f"{int(t/1000)}k" if t >= 1000 else f"{int(t)}" for t in ticks]
    ax.set_yticks(pos)
    ax.set_yticklabels(labels)
    ax.set_ylabel("Hz")
    return ax


def format_time_ticks(ax):
    """m:s:ms tick labels on the time axis (vispy_ext.py ExtTicker's
    timestamp mode; units.py sec_to_timestamp convention)."""
    from matplotlib.ticker import FuncFormatter

    def fmt(x, _pos):
        neg = x < 0
        x = abs(x)
        m = int(x // 60)
        s = int(x) % 60
        ms = int(round((x - int(x)) * 1000))
        base = f"{m}:{s:02d}" + (f".{ms:03d}".rstrip("0").rstrip(".") if ms else "")
        return ("-" if neg else "") + base

    ax.xaxis.set_major_formatter(FuncFormatter(fmt))
    return ax


def _mel_grid_rows(n_bins, sr):
    """Rows of a uniform mel grid over bins 1..n_bins-1 (the GLSL
    MelTransform's job): the bin each row shows, and the grid (host)."""
    freqs = np.arange(n_bins) / (2 * (n_bins - 1)) * sr
    mel_grid = np.linspace(units.to_mel(freqs[1]), units.to_mel(freqs[-1]), n_bins)
    hz_grid = units.to_Hz(mel_grid)
    rows = np.clip((hz_grid / (sr / 2) * (n_bins - 1)).astype(int), 0, n_bins - 1)
    return rows, mel_grid


def _gather_rows(img, rows):
    return img[torch.as_tensor(rows, device=img.device)]


def plot_spectrogram(mag, sr, hop, ax=None, vmin=-120, vmax=0, cmap="magma",
                     mel=True, markers=(), device="cuda"):
    """Render a magnitude spectrogram in dB with a mel-spaced y axis.
    ``mag``: a tensor (kept on its device) or a host array (uploaded to
    ``device``).

    ``markers`` may contain TraceLine / RegLine / box-style markers; they are
    drawn in the reference's colors (markers.py:25-563).
    """
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    db = units.to_dB(as_device_tensor(mag, device, torch.float32) + 1e-10)
    n_bins, n_frames = db.shape
    duration = n_frames * hop / sr
    if mel:
        rows, mel_grid = _mel_grid_rows(n_bins, sr)
        img = _gather_rows(db, rows)
        extent = (0, duration, mel_grid[0], mel_grid[-1])
        ax.set_ylabel("mel")
    else:
        img = db
        extent = (0, duration, 0, sr / 2)
        ax.set_ylabel("Hz")
    ax.imshow(img.cpu().numpy(), aspect="auto", origin="lower", extent=extent,
              vmin=vmin, vmax=vmax, cmap=get_cmap(cmap), interpolation="nearest")
    ax.set_xlabel("time (s)")
    y = (lambda f: units.to_mel(np.maximum(f, 1.0))) if mel else (lambda f: f)
    for m in markers:
        if hasattr(m, "times") and hasattr(m, "freqs"):      # TraceLine
            ax.plot(m.times, y(m.freqs), color=(1, 0, 0, 0.5), lw=1)
        elif hasattr(m, "speed_at"):                          # RegLine
            tt = np.linspace(m.t0, m.t1, 200)
            ax.plot(tt, y(np.power(2, m.speed_at(tt) + np.log2(2000))),
                    color=(0, 0, 1, 0.5), lw=1)
        elif hasattr(m, "a") and hasattr(m, "b"):             # box markers
            from matplotlib.patches import Rectangle

            t0, t1 = sorted((m.a[0], m.b[0]))
            f0, f1 = sorted((m.a[1], m.b[1]))
            ax.add_patch(Rectangle(
                (t0, y(np.array(f0))), t1 - t0, y(np.array(f1)) - y(np.array(f0)),
                fill=False, edgecolor=(1, 1, 1, 0.6)))
    return ax


def _db_norm(mag, vmin, vmax):
    db = units.to_dB(mag + 1e-10)
    return torch.clamp((db - vmin) / (vmax - vmin), 0.0, 1.0)


def compare_spectrograms(mag_a, mag_b, sr, hop, offset_b=0.0, ax=None,
                         vmin=-120, vmax=0, mel=True, device="cuda"):
    """Additive red/green 2-source overlay — the tapesynch workflow's main
    visual alignment check (spectrum.py:15-31's FlatRed/FlatGreen additive
    textures): source A renders into the red channel, source B (shifted by
    ``offset_b`` seconds, the LagSample.d readout) into green; aligned
    content fuses to yellow, misaligned content fringes red/green.
    """
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    mag_a = as_device_tensor(mag_a, device, torch.float32)
    mag_b = as_device_tensor(mag_b, device, torch.float32).to(mag_a.device)
    a = _db_norm(mag_a, vmin, vmax)
    b = _db_norm(mag_b, vmin, vmax)
    if a.shape[0] != b.shape[0]:
        # different bin counts would silently draw source B compressed into
        # the wrong frequency range on the shared [0, sr/2] row grid
        raise ValueError(
            f"both spectrograms must share fft settings: {a.shape[0]} vs "
            f"{b.shape[0]} frequency bins")
    off_frames = int(round(offset_b * sr / hop))
    n_bins = a.shape[0]  # == b.shape[0] per the guard above
    n_frames = max(a.shape[1], b.shape[1] + max(0, off_frames)) - min(0, off_frames)
    rgb = torch.zeros((n_bins, n_frames, 3), dtype=torch.float32, device=a.device)
    a0 = max(0, -off_frames)
    rgb[:, a0: a0 + a.shape[1], 0] = a
    b0 = max(0, off_frames)
    rgb[:, b0: b0 + b.shape[1], 1] = b
    duration = n_frames * hop / sr
    t0 = -a0 * hop / sr
    if mel:
        rows, mel_grid = _mel_grid_rows(n_bins, sr)
        rgb = _gather_rows(rgb, rows)
        extent = (t0, t0 + duration, mel_grid[0], mel_grid[-1])
        ax.set_ylabel("mel")
    else:
        extent = (t0, t0 + duration, 0, sr / 2)
        ax.set_ylabel("Hz")
    ax.imshow(rgb.cpu().numpy(), aspect="auto", origin="lower", extent=extent,
              interpolation="nearest")
    ax.set_xlabel("time (s)")
    return ax


def _save_figure(path, sr, draw, kwargs):
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 6))
    draw(ax)
    apply_freq_ticks(ax, sr, mel=kwargs.get("mel", True))
    format_time_ticks(ax)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def save_comparison(path, mag_a, mag_b, sr, hop, **kwargs):
    return _save_figure(path, sr, lambda ax: compare_spectrograms(
        mag_a, mag_b, sr, hop, ax=ax, **kwargs), kwargs)


def plot_speed_curves(curves, labels=None, ax=None):
    """Plot master speed / lag curves ((n, 2) arrays) like the upper canvas
    view (spectrum.py:290-314)."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    for i, data in enumerate(curves):
        label = labels[i] if labels else None
        ax.plot(data[:, 0], data[:, 1], lw=1.5, alpha=0.8, label=label)
    ax.set_xlabel("time (s)")
    if labels:
        ax.legend(framealpha=0.75)
    return ax


def save_spectrogram(path, mag, sr, hop, **kwargs):
    return _save_figure(path, sr, lambda ax: plot_spectrogram(
        mag, sr, hop, ax=ax, **kwargs), kwargs)
