"""The port's image writers against the JAX package on the CPU.

Given the same magnitude, each HTML page equals JAX's outside its PNG
payload (template, meta JSON, markers), and the decoded RGB equals JAX's
except at <= 1e-4 of pixels, each one step apart (a colormap table entry,
or one level of a channel): float32 ``log10`` may differ by an ulp between
numpy and torch, which moves a level that sits on an edge.  From audio
through ``view``, <= 1e-3 of pixels differ (the two STFTs round apart).
The audition page's WAV payloads are byte-identical and its strips, which
are made from audio too, follow ``view``'s rule.  The takes have a noise
floor at -80 dB, as a transfer has: in digital silence the bins near the
-120 dB end of the scale are the FFTs' float32 roundoff, and there the two
packages' levels differ at ~3e-3 of pixels.  The matplotlib figure functions write PNGs (where
matplotlib is present), and their images match JAX's.  The colormap tables
equal matplotlib's lookup for every name the viewer offers."""

import base64
import json
import re
import struct
import zlib

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.models import audition as aud_j
from pyaudiorestoration_tpu.models import markers as mk_j
from pyaudiorestoration_tpu.models import viz as viz_j
from pyaudiorestoration_tpu.models import viz_html as vh_j
from pyaudiorestoration_tpu.ops import fourier as fj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.models import audition as aud_t
from pyaudiorestoration_tpu_torch.models import markers as mk_t
from pyaudiorestoration_tpu_torch.models import viz as viz_t
from pyaudiorestoration_tpu_torch.models import viz_html as vh_t

torch.set_num_threads(2)
SR = 22050
_B64 = re.compile(r'base64,([A-Za-z0-9+/=]+)"')


def _take(seconds=4.0, seed=0, sr=SR):
    """Noise swelling from a -80 dB floor (levels across the whole dB range)
    over a wobbling 2 kHz tone, stereo float32."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    ramp = np.linspace(0.0, 1.0, n) ** 4
    tone = 0.3 * np.sin(2 * np.pi * 2000 * (t + 0.002 * np.sin(2 * np.pi * 1.5 * t)))
    x = rng.standard_normal(n) * (0.3 * ramp + 1e-4) + tone
    return np.stack([x, 0.6 * x], -1).astype(np.float32)


def _mag(seconds=4.0, seed=0):
    return np.asarray(fj.get_mag(_take(seconds, seed)[:, 0], 1024, 256))


def _payloads(page):
    """The page with every base64 payload cut out, and the payloads."""
    return _B64.sub('base64,"', page), [base64.b64decode(p) for p in _B64.findall(page)]


def _decode_png(png):
    """(h, w, 3) uint8 of the stdlib PNG of ``_png_b64`` (one IDAT, filter 0)."""
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", png[16:24])
    i = png.index(b"IDAT") + 4
    n = struct.unpack(">I", png[i - 8:i - 4])[0]
    raw = np.frombuffer(zlib.decompress(png[i:i + n]), np.uint8).reshape(h, 1 + 3 * w)
    assert np.all(raw[:, 0] == 0)
    return raw[:, 1:].reshape(h, w, 3)


def _one_table_step(a, b, table, share):
    """a and b differ at <= ``share`` of pixels, each such pixel by one step
    of ``table`` (adjacent entries)."""
    diff = np.any(a != b, -1)
    assert diff.mean() <= share, diff.mean()
    index = {}
    for i, c in enumerate(map(tuple, table)):
        index.setdefault(c, []).append(i)
    for pa, pb in zip(a[diff], b[diff]):
        steps = [abs(i - j) for i in index[tuple(pa)] for j in index[tuple(pb)]]
        assert min(steps) == 1, (pa, pb)


def _one_level(a, b, share):
    """a and b differ at <= ``share`` of pixels, by one level a channel."""
    diff = np.any(a != b, -1)
    assert diff.mean() <= share, diff.mean()
    assert np.abs(a.astype(int) - b).max() <= 1


def _read(path):
    return open(path, encoding="utf-8").read()


@pytest.mark.parametrize("cmap", ["izo", "magma", "inferno", "viridis", "gray"])
def test_viewer_page_matches_jax(tmp_path, cmap):
    mag = _mag()
    kw = dict(markers=[{"t": [0.5, 1.0], "f": [2000.0, 2100.0], "color": "#0f0"}],
              title="take <1>", cmap=cmap)
    vh_j.save_interactive_html(str(tmp_path / "j.html"), mag, SR, 256, **kw)
    vh_t.save_interactive_html(str(tmp_path / "t.html"), mag, SR, 256, device="cpu", **kw)
    page_j, (png_j,) = _payloads(_read(tmp_path / "j.html"))
    page_t, (png_t,) = _payloads(_read(tmp_path / "t.html"))
    assert page_t == page_j
    rgb = _decode_png(png_t)
    assert rgb.shape == (513, mag.shape[1], 3)
    _one_table_step(rgb, _decode_png(png_j), vh_t.cmap_table(cmap), 1e-4)


def test_render_rgb_on_a_tensor_and_max_rows():
    """A tensor keeps its device; ``max_rows`` caps the rows; the geometry
    is the page's meta."""
    mag = _mag()
    rgb, meta = vh_t.render_rgb(torch.as_tensor(mag), SR, 256, max_rows=200, cmap="gray")
    assert rgb.dtype == np.uint8 and rgb.shape == (200, mag.shape[1], 3)
    assert meta == {"w": mag.shape[1], "h": 200, "duration": mag.shape[1] * 256 / SR,
                    "fmin": 20.0, "fmax": SR / 2}
    assert np.all(rgb[..., 0] == rgb[..., 1])  # gray


def test_unknown_colormap_raises_listing_the_offered_names():
    with pytest.raises(ValueError, match="offered: izo, magma, inferno, viridis, gray"):
        vh_t.render_rgb(_mag(1.0), SR, 256, cmap="jet", device="cpu")


@pytest.mark.parametrize("cmap", ["izo", "magma", "inferno", "viridis", "gray"])
def test_colormap_tables_equal_matplotlibs_lookup(cmap):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    x = rng.random(100_000).astype(np.float32)
    x[:3] = [0.0, 1.0, np.nextafter(np.float32(1), np.float32(0))]
    cm = viz_j.get_cmap(cmap)
    if isinstance(cm, str):
        import matplotlib

        cm = matplotlib.colormaps[cm]
    want = (cm(x)[..., :3] * 255).astype(np.uint8)
    got = vh_t.cmap_table(cmap)[np.minimum((x * 256).astype(np.int64), 255)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset_b", [0.0, 0.3, -0.2])
def test_compare_page_matches_jax(tmp_path, offset_b):
    mag_a, mag_b = _mag(seed=0), _mag(3.5, seed=1)
    vh_j.save_interactive_compare_html(str(tmp_path / "j.html"), mag_a, mag_b, SR, 256,
                                       offset_b=offset_b)
    vh_t.save_interactive_compare_html(str(tmp_path / "t.html"), mag_a, mag_b, SR, 256,
                                       offset_b=offset_b, device="cpu")
    page_j, (png_j,) = _payloads(_read(tmp_path / "j.html"))
    page_t, (png_t,) = _payloads(_read(tmp_path / "t.html"))
    assert page_t == page_j
    rgb = _decode_png(png_t)
    assert rgb.shape[1] == json.loads(re.search(r"const META = (\{.*?\});",
                                                page_t).group(1))["w"]
    assert np.all(rgb[..., 2] == 0)
    _one_level(rgb, _decode_png(png_j), 1e-4)
    with pytest.raises(ValueError):
        vh_t.save_interactive_compare_html(str(tmp_path / "x.html"), mag_a, mag_a[:-1],
                                           SR, 256, device="cpu")


def test_view_cli_matches_jax(tmp_path, capsys):
    """From audio through ``view`` (with ``--trail`` on the tone) in both
    packages: the same page outside the image and the markers, the traced
    curve within 1 Hz, <= 1e-3 of pixels apart."""
    path = str(tmp_path / "take.wav")
    wavfile.write(path, SR, _take())
    argv = ["view", path, "--trail", "0.3", "2000", "3.5", "2000"]
    assert cli_j.main([*argv, "-o", str(tmp_path / "j.html")]) == 0
    assert cli_t.main([*argv, "-o", str(tmp_path / "t.html"), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"outputs": [str(tmp_path / "t.html")]}
    pages = []
    for name in ("j", "t"):
        page, (png,) = _payloads(_read(tmp_path / f"{name}.html"))
        mk = json.loads(re.search(r"const MARKERS = (\[.*?\]);", page).group(1))
        pages.append((re.sub(r"const MARKERS = \[.*?\];", "", page), mk, _decode_png(png)))
    (page_j, mk_j_, rgb_j), (page_t, mk_t_, rgb_t) = pages
    assert page_t == page_j
    np.testing.assert_allclose(mk_t_[0]["t"], mk_j_[0]["t"], rtol=1e-12)
    np.testing.assert_allclose(mk_t_[0]["f"], mk_j_[0]["f"], atol=1.0)
    t = np.asarray(mk_t_[0]["t"])
    truth = 2000 * (1 + 0.002 * 2 * np.pi * 1.5 * np.cos(2 * np.pi * 1.5 * t))
    assert np.all(np.abs(np.asarray(mk_t_[0]["f"]) - truth) < 0.01 * truth)
    assert np.any(rgb_t != rgb_j, -1).mean() <= 1e-3


def test_audition_page_matches_jax(tmp_path):
    """Two takes (the second cut by ``max_seconds``): byte-identical WAV
    payloads, strips one level apart at <= 1e-3 of pixels, and the same
    page around them."""
    a = _take(3.0)
    b = 0.5 * _take(4.0, seed=2)
    takes = [("orig", a), ("restored", b)]
    kw = dict(title="t </script>", max_seconds=3.5)
    aud_j.save_audition_html(str(tmp_path / "j.html"), takes, SR, **kw)
    aud_t.save_audition_html(str(tmp_path / "t.html"), takes, SR, device="cpu", **kw)
    page_j, pay_j = _payloads(_read(tmp_path / "j.html"))
    page_t, pay_t = _payloads(_read(tmp_path / "t.html"))
    assert page_t == page_j
    assert len(pay_t) == 4  # a strip and a WAV a lane
    for got, want in zip(pay_t, pay_j):
        if got[:4] == b"RIFF":
            assert got == want
        else:
            strip = _decode_png(got)
            assert strip.shape[0] == 160
            _one_level(strip, _decode_png(want), 1e-3)


def test_listen_cli_writes_the_page(tmp_path, capsys):
    paths = []
    for name, x in (("a", _take(2.0)), ("b", _take(2.0, seed=3))):
        paths.append(str(tmp_path / f"{name}.wav"))
        wavfile.write(paths[-1], SR, x)
    out = str(tmp_path / "aud.html")
    assert cli_t.main(["listen", *paths, "-o", out, "--start", "0.5", "--device",
                       "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "outputs": [out]}
    page = _read(out)
    assert page.count("<audio") == 2 and "a.wav vs b.wav" in page
    wav = base64.b64decode(page.split("audio/wav;base64,")[1].split('"')[0])
    assert len(wav) == 44 + int(1.5 * SR) * 2 * 2


# ---------------------------------------------------------------------------
# the matplotlib figures (tests/test_aux.py:218, tests/test_compare_preview.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def plt():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    yield plt
    plt.close("all")


def test_save_spectrogram_with_markers(tmp_path, plt):
    mag = np.abs(np.random.default_rng(2).standard_normal((129, 200))).astype(np.float32)
    t = np.linspace(0.0, 1.0, 10)
    markers = [mk_t.TraceLine(t, np.full(10, 440.0)), mk_t.RegLine(0.2, 1.0, 0.1, 3.0, 0.0, 0.0),
               mk_t.DropoutSample((0.2, 300.0), (0.4, 900.0))]
    path = viz_t.save_spectrogram(str(tmp_path / "s.png"), mag, 8000, 64, markers=markers,
                                  device="cpu")
    assert (tmp_path / "s.png").stat().st_size > 1000 and path == str(tmp_path / "s.png")


@pytest.mark.parametrize("mel", [True, False])
def test_plot_spectrogram_image_matches_jax(plt, mel):
    mag = _mag(2.0)
    images = []
    for viz, kw in ((viz_j, {}), (viz_t, {"device": "cpu"})):
        fig, ax = plt.subplots()
        viz.plot_spectrogram(mag, SR, 256, ax=ax, mel=mel, cmap="izo",
                             markers=[mk_j.TraceLine(np.linspace(0, 1, 5), np.full(5, 2e3))],
                             **kw)
        images.append((np.asarray(ax.images[0].get_array()), ax.images[0].get_extent(),
                       ax.get_ylabel()))
    (a, ext_a, ya), (b, ext_b, yb) = images
    assert ext_a == ext_b and ya == yb and a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-4)


@pytest.mark.parametrize("mel", [True, False])
def test_compare_spectrograms_matches_jax_and_fuses_channels(tmp_path, plt, mel):
    mag = np.asarray(fj.get_mag(_take(1.0)[:, 0], 512, 128))
    off_s = 0.25
    off = int(round(off_s * SR / 128))
    images = []
    for viz, kw in ((viz_j, {}), (viz_t, {"device": "cpu"})):
        fig, ax = plt.subplots()
        viz.compare_spectrograms(mag, mag, SR, 128, offset_b=-off_s, mel=mel, ax=ax, **kw)
        images.append((np.asarray(ax.images[0].get_array()), ax.images[0].get_extent()))
    (a, ext_a), (b, ext_b) = images
    assert ext_a == ext_b
    np.testing.assert_allclose(b, a, atol=1e-6)
    if not mel:
        # B shifted left by off frames: in the overlap red == green
        np.testing.assert_allclose(b[:, off:mag.shape[1], 0], b[:, :mag.shape[1] - off, 1],
                                   atol=1e-6)
        assert b[:, mag.shape[1] - off:, 1].max() > 0.3
    path = str(tmp_path / "cmp.png")
    assert viz_t.save_comparison(path, mag, mag, SR, 128, offset_b=-off_s, mel=mel,
                                 device="cpu") == path
    assert (tmp_path / "cmp.png").stat().st_size > 0
    with pytest.raises(ValueError, match="share fft settings"):
        viz_t.compare_spectrograms(mag, mag[:-1], SR, 128, device="cpu")


def test_izo_colormap_and_tick_helpers(plt):
    cmap = viz_t.get_cmap("izo")
    assert cmap.N == 256 and viz_t.get_cmap("izo").name == "izo"
    assert viz_t.get_cmap("magma") == "magma"
    fig, ax = plt.subplots()
    viz_t.apply_freq_ticks(ax, 44100, mel=True)
    labels = [t.get_text() for t in ax.get_yticklabels()]
    assert "1k" in labels and "20k" in labels and "50k" not in labels
    viz_t.format_time_ticks(ax)
    fmt = ax.xaxis.get_major_formatter()
    assert (fmt(61.5, 0), fmt(0.25, 0), fmt(120.0, 0)) == ("1:01.5", "0:00.25", "2:00")


def test_plot_speed_curves(plt):
    fig, ax = plt.subplots()
    curves = [np.stack([np.linspace(0, 1, 50), np.sin(np.linspace(0, 6, 50))], -1)] * 2
    viz_t.plot_speed_curves(curves, labels=["a", "b"], ax=ax)
    assert len(ax.lines) == 2 and ax.get_legend() is not None
