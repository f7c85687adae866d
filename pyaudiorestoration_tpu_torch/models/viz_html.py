"""Self-contained interactive HTML spectrogram viewer (counterpart of
pyaudiorestoration_tpu/models/viz_html.py).

The reference's main interactive affordance is the vispy canvas: pan/zoom a
mel-scaled spectrogram, read time/frequency under the cursor, see marker
overlays (spectrum.py:224-605, vispy_ext.py:148-199).  On a headless
deployment there is no Qt/GL stack, so this module renders the spectrogram
once and embeds it in a single HTML file with ~100 lines of
dependency-free JavaScript providing:

* wheel zoom around the cursor (X-only with Shift, like PanZoomCameraExt's
  modifier zoom, vispy_ext.py:19-145), drag pan, double-click reset
* a cursor readout of time (m:s:ms) and frequency in Hz (inverting the mel
  row mapping in JS, the MelTransform imap, vispy_ext.py:185-195)
* marker polylines (e.g. traced frequency curves) drawn over the image

The image is rendered on the device (:func:`render_rgb`): the mel rows are
picked on the host with ``np.searchsorted`` as in the JAX package, then
gathered from the magnitude, turned into dB, normalised and looked up in a
256-entry uint8 colormap table there; only the (H, W, 3) uint8 image is
downloaded.  The tables are data files (``izo_cmap.npy``, the reference's
own map, and ``cmap_tables.npy``), not matplotlib, which this module never
imports.  For every offered name the lookup equals matplotlib's
``(cm(x)[..., :3] * 255).astype(uint8)``.

Open the file in any browser; nothing is fetched from the network.
"""

from __future__ import annotations

import base64
import html as _html
import io
import json
import os

import numpy as np
import torch

from ..ops import units
from ..utils.device import as_device_tensor

__all__ = ["CMAPS", "cmap_table", "mel_rows", "render_rgb", "save_interactive_html",
           "save_interactive_compare_html"]

_HERE = os.path.dirname(os.path.abspath(__file__))
# cmap_tables.npy holds (4, 256, 3) uint8: these maps, in this order
_TABLE_NAMES = ("magma", "inferno", "viridis", "gray")
CMAPS = ("izo",) + _TABLE_NAMES  # the colormap names the viewer offers

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
 body {{ margin:0; background:#111; color:#ddd; font:13px monospace; }}
 #bar {{ padding:6px 10px; }} #wrap {{ position:relative; }}
 canvas {{ display:block; width:100vw; height:calc(100vh - 30px); cursor:crosshair; }}
</style></head><body>
<div id="bar">{title} &nbsp; <span id="readout"></span>
 &nbsp;&nbsp;<span style="color:#888">drag: pan &middot; wheel: zoom
 (shift: X only) &middot; dblclick: reset</span></div>
<div id="wrap"><canvas id="c"></canvas></div>
<script>
const META = {meta};
const MARKERS = {markers};
const img = new Image();
img.src = "data:image/png;base64,{png}";
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
const readout = document.getElementById("readout");
let sx = 1, sy = 1, tx = 0, ty = 0;   // view transform (image px -> canvas px)
function resize() {{
  cv.width = cv.clientWidth; cv.height = cv.clientHeight;
  sx = cv.width / META.w; sy = cv.height / META.h; tx = 0; ty = 0; draw();
}}
function draw() {{
  ctx.setTransform(1,0,0,1,0,0);
  ctx.fillStyle = "#111"; ctx.fillRect(0,0,cv.width,cv.height);
  ctx.setTransform(sx,0,0,sy,tx,ty);
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(img, 0, 0);
  ctx.lineWidth = 1.5 / Math.max(sx, sy);
  for (const m of MARKERS) {{
    ctx.strokeStyle = m.color; ctx.beginPath();
    for (let i = 0; i < m.t.length; i++) {{
      const x = m.t[i] / META.duration * META.w;
      const y = hz2row(m.f[i]);
      if (i) ctx.lineTo(x, y); else ctx.moveTo(x, y);
    }}
    ctx.stroke();
  }}
}}
// mel mapping (vispy_ext.py:185-195): row 0 = top = mel(f_max)
function mel(f) {{ return 1127.01048 * Math.log(1 + f / 700.0); }}
function imel(m) {{ return 700.0 * (Math.exp(m / 1127.01048) - 1); }}
function row2hz(r) {{
  const frac = 1 - r / META.h;
  return imel(mel(META.fmin) + frac * (mel(META.fmax) - mel(META.fmin)));
}}
function hz2row(f) {{
  const frac = (mel(f) - mel(META.fmin)) / (mel(META.fmax) - mel(META.fmin));
  return (1 - frac) * META.h;
}}
cv.addEventListener("mousemove", ev => {{
  const r = cv.getBoundingClientRect();
  const ix = (ev.clientX - r.left - tx) / sx, iy = (ev.clientY - r.top - ty) / sy;
  const t = ix / META.w * META.duration, f = row2hz(iy);
  if (t >= 0 && t <= META.duration && f >= 0)
    readout.textContent = (t/60|0) + ":" + String((t%60).toFixed(3)).padStart(6,"0")
      + "  " + f.toFixed(1) + " Hz";
  if (dragging) {{ tx += ev.movementX; ty += ev.movementY; draw(); }}
}});
let dragging = false;
cv.addEventListener("mousedown", () => dragging = true);
window.addEventListener("mouseup", () => dragging = false);
cv.addEventListener("wheel", ev => {{
  ev.preventDefault();
  const r = cv.getBoundingClientRect();
  const px = ev.clientX - r.left, py = ev.clientY - r.top;
  const k = Math.exp(-ev.deltaY * 0.0015);
  sx *= k; tx = px - (px - tx) * k;
  if (!ev.shiftKey) {{ sy *= k; ty = py - (py - ty) * k; }}
  draw();
}}, {{ passive: false }});
cv.addEventListener("dblclick", resize);
img.onload = resize;
window.addEventListener("resize", resize);
</script></body></html>
"""


def _png_b64(rgb_u8):
    """Encode an (H, W, 3) uint8 image as base64 PNG (pure stdlib: zlib
    deflate of filtered scanlines — no imaging dependency)."""
    import struct
    import zlib

    h, w, _ = rgb_u8.shape
    raw = b"".join(b"\x00" + rgb_u8[r].tobytes() for r in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    return base64.b64encode(png).decode("ascii")


def cmap_table(name) -> np.ndarray:
    """The (256, 3) uint8 table of an offered colormap; any other name
    raises ``ValueError``."""
    if name == "izo":
        # a ListedColormap of the float table: its lookup, times 255, truncated
        return (np.load(os.path.join(_HERE, "izo_cmap.npy")).astype(np.float64)
                * 255).astype(np.uint8)
    if name in _TABLE_NAMES:
        return np.load(os.path.join(_HERE, "cmap_tables.npy"))[_TABLE_NAMES.index(name)]
    raise ValueError(f"unknown colormap {name!r}; offered: {', '.join(CMAPS)}")


def mel_rows(n_bins: int, sr, h: int, fmin) -> np.ndarray:
    """The bin shown on each of ``h`` image rows, top row = Nyquist, on a
    mel grid down to ``fmin`` (host float64, ``np.searchsorted`` as the JAX
    package picks them)."""
    n_fft = 2 * (n_bins - 1)
    freqs = np.arange(n_bins) / n_fft * sr
    mel_grid = np.linspace(float(units.to_mel(sr / 2)), float(units.to_mel(fmin)), h)
    return np.clip(np.searchsorted(freqs, np.asarray(units.to_Hz(mel_grid))),
                   0, n_bins - 1)


def norm_rows(mag, rows, vmin, vmax):
    """The clipped dB level in [0, 1] of the ``rows`` of the magnitude
    tensor ``mag``, on its device: float32 ``20 log10(mag + 1e-7)`` with the
    JAX package's roundings (the gather commutes with the elementwise
    steps)."""
    db = 20.0 * torch.log10(mag[torch.as_tensor(rows, device=mag.device)] + 1e-7)
    return torch.clamp((db - vmin) / (vmax - vmin), 0.0, 1.0)


def _meta(n_frames, h, sr, hop, fmin):
    return {"w": n_frames, "h": h, "duration": n_frames * hop / sr, "fmin": fmin,
            "fmax": sr / 2}


def render_rgb(mag, sr, hop, vmin=-120, vmax=0, cmap="izo", fmin=20.0, max_rows=1024,
               device="cuda"):
    """The viewer's image of a (n_bins, n_frames) magnitude spectrogram: a
    tensor keeps its device, a host array is uploaded to ``device``.
    Returns the (h, n_frames, 3) uint8 host image (h = min(max_rows,
    n_bins)) and the page's geometry."""
    table = cmap_table(cmap)
    mag = as_device_tensor(mag, device, torch.float32)
    n_bins, n_frames = mag.shape
    h = min(max_rows, n_bins)
    norm = norm_rows(mag, mel_rows(n_bins, sr, h, fmin), vmin, vmax)
    # matplotlib's index of a float in [0, 1]: min(int(x * N), N - 1)
    idx = torch.clamp((norm * 256).to(torch.int64), max=255)
    rgb = torch.as_tensor(table, device=mag.device)[idx]
    return rgb.cpu().numpy(), _meta(n_frames, h, sr, hop, fmin)


def _write_page(path, title, meta, markers, rgb):
    page = _PAGE.format(title=_html.escape(str(title)), meta=json.dumps(meta),
                        markers=markers, png=_png_b64(rgb))
    with io.open(path, "w", encoding="utf-8") as f:
        f.write(page)
    return path


def save_interactive_html(path, mag, sr, hop, markers=(), title="spectrogram",
                          vmin=-120, vmax=0, cmap="izo", fmin=20.0,
                          max_rows=1024, device="cuda"):
    """Write a dependency-free interactive viewer for a magnitude
    spectrogram.  ``markers``: iterable of dicts {"t": [...], "f": [...],
    "color": "#f00"} (e.g. a traced frequency curve).  ``cmap``: one of
    :data:`CMAPS`.  Returns ``path``."""
    rgb, meta = render_rgb(mag, sr, hop, vmin, vmax, cmap, fmin, max_rows, device)
    mk = [{"t": list(map(float, m["t"])), "f": list(map(float, m["f"])),
           "color": m.get("color", "#ff5050")} for m in markers]
    return _write_page(path, title, meta, json.dumps(mk), rgb)


def save_interactive_compare_html(path, mag_a, mag_b, sr, hop, offset_b=0.0,
                                  title="compare", vmin=-120, vmax=0,
                                  fmin=20.0, max_rows=1024, device="cuda"):
    """Interactive red/green 2-source overlay (the tapesynch alignment
    check, spectrum.py:15-31): source A -> red, source B (shifted by
    ``offset_b`` seconds) -> green; aligned content fuses to yellow.  Same
    pan/zoom/readout page as ``save_interactive_html``; the overlay is
    built on the device."""
    mag_a = as_device_tensor(mag_a, device, torch.float32)
    mag_b = as_device_tensor(mag_b, mag_a.device, torch.float32).to(mag_a.device)
    if mag_a.shape[0] != mag_b.shape[0]:
        raise ValueError("both spectrograms must share fft settings")
    n_bins, wa = mag_a.shape
    wb = mag_b.shape[1]
    off = int(round(offset_b * sr / hop))
    n_frames = max(wa, wb + max(0, off)) - min(0, off)
    h = min(max_rows, n_bins)
    rows = mel_rows(n_bins, sr, h, fmin)
    # (x * 255).astype(uint8) of JAX's float overlay, whose other cells are 0
    rgb = torch.zeros((h, n_frames, 3), dtype=torch.uint8, device=mag_a.device)
    a0, b0 = max(0, -off), max(0, off)
    rgb[:, a0:a0 + wa, 0] = (norm_rows(mag_a, rows, vmin, vmax) * 255).to(torch.uint8)
    rgb[:, b0:b0 + wb, 1] = (norm_rows(mag_b, rows, vmin, vmax) * 255).to(torch.uint8)
    return _write_page(path, title, _meta(n_frames, h, sr, hop, fmin), "[]",
                       rgb.cpu().numpy())
