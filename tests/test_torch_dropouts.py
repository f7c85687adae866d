"""The port's dropout healing and batch dropout repair against the JAX
package on the CPU: ``heal`` and the streamed heal within 1e-5 of JAX's;
``process_heuristic`` within 1e-5 of JAX's ``filter_backend="host"`` and
5e-4 of JAX's device path (the tolerance of
tests/test_host_loop_removal.py:153); the streamed heuristic within 1e-5 of
the in-memory one in the interior (tests/test_streaming_tools.py:157);
``process_max_mono`` within 1e-5 in memory and streamed; the CLI end to end
against the JAX CLI's files; ``.drop`` projects read by either package."""

import json

import numpy as np
import pytest
import scipy.signal as dsp
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.models import markers as mk_j
from pyaudiorestoration_tpu.ops import fourier as fj
from pyaudiorestoration_tpu.ops import units as uj
from pyaudiorestoration_tpu.pipelines import dropouts as dj
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu.utils import project as pj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.models import markers as mk_t
from pyaudiorestoration_tpu_torch.ops import units as ut
from pyaudiorestoration_tpu_torch.pipelines import dropouts as dt
from pyaudiorestoration_tpu_torch.utils import audio_io as at
from pyaudiorestoration_tpu_torch.utils import project as pt

torch.set_num_threads(2)
SR = 8000


def _noisy_tone(n, sr=SR, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    sig = np.sin(2 * np.pi * 880 * t) * 0.4 + rng.standard_normal(n) * 0.01
    return np.stack([sig, 0.6 * sig], -1).astype(np.float32)


def _carved(n=int(3.1 * SR), seed=2):
    """A noisy tone with two dropouts (x0.05 over 100 ms) and their boxes;
    the third box overlaps the second, the fourth is empty in frequency."""
    x = _noisy_tone(n, seed=seed)
    for c0 in (int(1.0 * SR), int(2.2 * SR)):
        x[c0:c0 + 800] *= 0.05
    boxes = [((0.98, 300.0), (1.12, 3000.0), 0.5), ((2.18, 300.0), (2.32, 3500.0), 0.5),
             ((2.25, 600.0), (2.40, 2000.0), 0.8), ((0.3, 900.0), (0.4, 900.0), 0.5)]
    return x, boxes


def _drops(mk, boxes):
    return [mk.DropoutSample(a, b, s) for a, b, s in boxes]


def _write(path, x, sr=SR):
    at.write_wav(str(path), x, sr)
    return str(path)


def _read(path):
    return at.read_file(path)[0]


@pytest.mark.parametrize("fft_size,overlap", [(512, 16), (256, 4)])
def test_boxes_array_equal(fft_size, overlap):
    _, boxes = _carved()
    for n_boxes in (0, 3, 4):
        np.testing.assert_array_equal(
            dt._boxes_array(_drops(mk_t, boxes[:n_boxes]), SR, fft_size // overlap,
                            fft_size),
            dj._boxes_array(_drops(mk_j, boxes[:n_boxes]), SR, fft_size // overlap,
                            fft_size))


@pytest.mark.parametrize("fft_size,overlap,channels", [(512, 16, None), (256, 4, [1])])
def test_heal_matches_jax(fft_size, overlap, channels):
    x, boxes = _carved()
    ref = dj.heal(x, SR, _drops(mk_j, boxes), fft_size, overlap, channels)
    got = dt.heal(x, SR, _drops(mk_t, boxes), fft_size, overlap, channels, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    c = channels[0] if channels else 0
    seg = slice(int(1.0 * SR) + 100, int(1.0 * SR) + 700)
    assert np.abs(got[seg, 0]).mean() > 2 * np.abs(x[seg, c]).mean()  # the heal lifted it


def test_heal_file_streamed_matches_memory_and_jax(tmp_path):
    x, boxes = _carved(int(3.3 * SR), seed=4)
    src = _write(tmp_path / "take.wav", x)
    mem = _read(dt.heal_file(src, _drops(mk_t, boxes), suffix="_mem", stream=False,
                             device="cpu"))
    got = _read(dt.heal_file(src, _drops(mk_t, boxes), suffix="_str", stream=True,
                             device="cpu"))
    ref = aj.read_file(dj.heal_file(src, _drops(mk_j, boxes), suffix="_jstr",
                                    stream=True))[0]
    assert got.shape == ref.shape == mem.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got[512:-512], mem[512:-512], atol=1e-4)


def test_detect_dropouts_matches_jax():
    x, _ = _carved()
    hop = 512 // 16
    mag = np.asarray(fj.get_mag(x[:, 0], 512, hop))
    kw = dict(t0=0.5, t1=2.8, f_lower=300.0, f_upper=3000.0)
    ref = dj.detect_dropouts(uj.to_dB(mag), SR, hop, 512, **kw)
    got = dt.detect_dropouts(ut.to_dB(mag), SR, hop, 512, **kw)
    assert len(got) == len(ref) >= 2
    for g, r in zip(got, ref):
        assert g.to_cfg() == r.to_cfg()


def test_units_match_jax():
    a = np.array([1e-3, 0.5, 2.0, 440.0], np.float32)
    for name in ("to_dB", "to_fac", "to_mel", "to_Hz"):
        ref = getattr(uj, name)(a)
        np.testing.assert_allclose(getattr(ut, name)(a), ref, rtol=1e-6)
        np.testing.assert_allclose(getattr(ut, name)(torch.from_numpy(a)).numpy(), ref,
                                   rtol=1e-6)
    np.testing.assert_allclose(ut.normalize(torch.from_numpy(a)).numpy(),
                               uj.normalize(a, copy=True), rtol=1e-7)
    for f in (0.0, 27.5, 440.0, 4186.0):
        assert ut.pitch(f) == uj.pitch(f)
    for t in (0.0, 61.25, 3725.5):
        assert ut.sec_to_timestamp(t) == uj.sec_to_timestamp(t)
        assert ut.t_2_m_s_ms(-t) == uj.t_2_m_s_ms(-t)


def _dipped_music(sr=8000, seconds=2.0, seed=5):
    """tests/test_host_loop_removal.py:119-150's signal: band-limited noise
    with two smooth (hann-shaped) dips, stereo."""
    n = int(sr * seconds)
    rng = np.random.default_rng(seed)
    sos = dsp.butter(4, [1500 / (sr / 2), 3500 / (sr / 2)], btype="band", output="sos")
    music = dsp.sosfilt(sos, rng.standard_normal(n)).astype(np.float32)
    music *= 0.3 / np.abs(music).max()
    env = np.ones(n, np.float32)
    for c in (int(0.35 * n), int(0.65 * n)):
        w = int(0.03 * sr)
        env[c - w:c + w] *= 1.0 - 0.95 * np.hanning(2 * w).astype(np.float32)
    sig = (music * env)[:, None] * np.array([[1.0, 0.8]], np.float32)
    return sig + (0.005 * rng.standard_normal((n, 2))).astype(np.float32)


HEUR = dict(fft_size=512, fft_overlap=8, max_width=0.06, max_slope=0.5, num_bands=6,
            bottom_freedom=2.0, f_lower=1000.0, f_upper=3800.0)


def test_process_heuristic_matches_jax(tmp_path):
    sig = _dipped_music()
    src = _write(tmp_path / "dr.wav", sig)
    timings = {}
    got = _read(dt.process_heuristic(src, suffix="_t", device="cpu", timings=timings,
                                     **HEUR))
    host = aj.read_file(dj.process_heuristic(src, suffix="_jh", filter_backend="host",
                                             **HEUR))[0]
    dev = aj.read_file(dj.process_heuristic(src, suffix="_jd", **HEUR))[0]
    assert got.shape == sig.shape and np.all(np.isfinite(got))
    assert sorted(timings) == ["cascade_s", "heuristic_fac_s", "read_s", "spectrum_s",
                               "write_s"]
    np.testing.assert_allclose(got, host, atol=1e-5)
    np.testing.assert_allclose(got, dev, atol=5e-4)
    assert np.abs(got - sig).max() > 1e-2  # the dips were patched


def test_band_vols_and_interp_match_host():
    rng = np.random.default_rng(9)
    mag = np.abs(rng.standard_normal((2, 257, 120))).astype(np.float32) + 1e-3
    pairs = dt._band_pairs(1000.0, 3800.0, 6) + [(1000, 1001)]  # a sub-bin band
    ref = dj._band_vols(uj.to_dB(mag), pairs, 512, SR)
    got = dt._band_vols_device(torch.from_numpy(mag), pairs, 512, SR)
    assert np.isnan(got[-1]).all() and np.isnan(ref[-1]).all()
    np.testing.assert_allclose(got[:-1], ref[:-1], rtol=1e-6)
    rows = rng.standard_normal((2, 120))
    n = 9001
    want = np.stack([np.interp(np.linspace(0, 1, n), np.linspace(0, 1, 120), r)
                     for r in rows])
    np.testing.assert_array_equal(dt._interp_rows(torch.from_numpy(rows), 0, n, n).numpy(),
                                  want)
    np.testing.assert_array_equal(
        dt._interp_rows(torch.from_numpy(rows), 4000, 6000, n).numpy(), want[:, 4000:6000])


def test_process_heuristic_streamed_matches_memory(tmp_path):
    """tests/test_streaming_tools.py:132-157's case at 22.05 kHz."""
    sr = 22050
    n = int(2.6 * sr)
    x = _noisy_tone(n, sr, seed=7)
    t = np.arange(n) / sr
    x += (np.sin(2 * np.pi * 6000 * t) * 0.2)[:, None].astype(np.float32)
    for c0 in (int(0.9 * sr), int(1.9 * sr)):
        x[c0:c0 + 400] *= 0.1
    src = _write(tmp_path / "s.wav", x, sr)
    mem = _read(dt.process_heuristic(src, 1024, 4, num_bands=6, suffix="_m", stream=False,
                                     device="cpu"))
    got = _read(dt.process_heuristic_streamed(src, 1024, 4, num_bands=6, suffix="_s",
                                              block_frames=64, device="cpu"))
    ref = aj.read_file(dj.process_heuristic(src, 1024, 4, num_bands=6, suffix="_j",
                                            filter_backend="host", stream=False))[0]
    assert got.shape == mem.shape == x.shape
    h = 4096
    np.testing.assert_allclose(got[h:-h], mem[h:-h], atol=1e-5)
    np.testing.assert_allclose(mem, ref, atol=1e-5)


@pytest.mark.parametrize("stream", [False, True])
def test_process_max_mono_matches_jax(tmp_path, stream):
    x = _noisy_tone(int(2.2 * SR), seed=11)
    x[:, 1] += 0.3 * np.sin(2 * np.pi * 1500 * np.arange(len(x)) / SR).astype(np.float32)
    src = _write(tmp_path / "st.wav", x)
    got = dt.process_max_mono(src, 512, 4, suffix="_t", stream=stream, device="cpu")
    ref = dj.process_max_mono(src, 512, 4, suffix="_j", stream=stream)
    assert [p.rsplit("/", 1)[-1] for p in got] == ["stmax_t.wav", "stmin_t.wav"]
    for g, r in zip(got, ref):
        a, b = _read(g), aj.read_file(r)[0]
        assert a.shape == b.shape == (len(x), 1)
        np.testing.assert_allclose(a, b, atol=1e-5)
    with pytest.raises(ValueError, match="stereo"):
        dt.process_max_mono(_write(tmp_path / "mono.wav", x[:, :1]), stream=stream,
                            device="cpu")


def test_drop_projects_read_by_either_package(tmp_path):
    _, boxes = _carved()
    settings = {"fft_size": 512, "fft_overlap": 16}
    pt.Project(".drop", settings, {"dropouts": _drops(mk_t, boxes)}).save(
        str(tmp_path / "t.drop"))
    pj.Project(".drop", settings, {"dropouts": _drops(mk_j, boxes)}).save(
        str(tmp_path / "j.drop"))
    for path in ("t.drop", "j.drop"):
        for P in (pt.Project, pj.Project):
            proj = P.load(str(tmp_path / path))
            assert (proj.fft_size, proj.fft_overlap) == (512, 16)
            assert [d.to_cfg() for d in proj.marker_list("dropouts")] == \
                [tuple(a) + tuple(b) + (s,) for a, b, s in boxes]


@pytest.mark.parametrize("argv", [
    ["--project", "{drop}"],
    ["--project", "{drop}", "--stream"],
    ["--detect", "0.5", "2.8", "300", "3000", "--fft-size", "512", "--fft-overlap", "16"],
])
def test_heal_cli_matches_jax(tmp_path, capsys, argv):
    x, boxes = _carved()
    src = _write(tmp_path / "take.wav", x)
    drop = str(tmp_path / "take.drop")
    pj.Project(".drop", {"fft_size": 512, "fft_overlap": 16},
               {"dropouts": _drops(mk_j, boxes)}).save(drop)
    argv = [a.format(drop=drop) for a in argv]
    assert cli_j.main(["heal", src, *argv, "--suffix", "_j"]) in (0, None)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli_t.main(["heal", src, *argv, "--suffix", "_t", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["num_dropouts"] == ref["num_dropouts"] >= 2
    np.testing.assert_allclose(_read(got["outputs"][0]),
                               aj.read_file(ref["outputs"][0])[0], atol=1e-5)


@pytest.mark.parametrize("mode", ["Heuristic", "MaxMono"])
def test_dropouts_batch_cli_matches_jax(tmp_path, capsys, mode):
    src = _write(tmp_path / "dr.wav", _dipped_music())  # JAX's compile is reused
    args = ["--mode", mode, "--fft-size", "512", "--fft-overlap", "8", "--num-bands", "6",
            "--f-lower", "1000", "--f-upper", "3800", "--max-width", "0.06"]
    assert cli_j.main(["dropouts-batch", src, *args, "--suffix", "_j"]) in (0, None)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert cli_t.main(["dropouts-batch", src, *args, "--suffix", "_t", "--device",
                       "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert len(got) == len(ref) == (1 if mode == "Heuristic" else 2)
    for g, r in zip(got, ref):
        # JAX's CLI runs its float32 device cascade: the 5e-4 of
        # test_process_heuristic_matches_jax
        np.testing.assert_allclose(_read(g), aj.read_file(r)[0], atol=5e-4)


def test_cuda_default_raises_without_a_card(tmp_path):
    x, boxes = _carved()
    src = _write(tmp_path / "take.wav", x)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dt.heal_file(src, _drops(mk_t, boxes))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dt.process_heuristic(src)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dt.process_max_mono(src)
