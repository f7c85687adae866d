"""The port's pan matching and dynamics matching against the JAX package on
the CPU.  Pan: ``measure_pan`` at JAX's factor (1e-5 relative), ``apply_pan``
and ``pan_file`` equal to JAX's to 1e-7, streamed within 1e-7 of in memory
(tests/test_streaming_tools.py:308-323), ``.pan`` projects and the ``pan``
CLI.  Decompressor: the windowed RMS within 1e-6 of JAX's and of the
reference loop (with a trailing ``n_valid``), ``match_dynamics`` and
``decompress_file`` within 1e-5 with and without ``--sync``, streamed within
5e-4 of in memory in the interior (tests/test_streaming_tools.py:326-351),
and the ``decompress`` CLI."""

import json

import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter1d

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.models import markers as mk_j
from pyaudiorestoration_tpu.pipelines import decompressor as dj
from pyaudiorestoration_tpu.pipelines import pan as pj
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu.utils import project as prj
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.models import markers as mk_t
from pyaudiorestoration_tpu_torch.pipelines import decompressor as dt
from pyaudiorestoration_tpu_torch.pipelines import pan as pt
from pyaudiorestoration_tpu_torch.utils import audio_io as at
from pyaudiorestoration_tpu_torch.utils import project as prt

torch.set_num_threads(2)
SR = 22050
BOXES = [((0.5, 100.0), (1.0, 8000.0)), ((1.5, 100.0), (2.0, 8000.0))]


def _write(path, x, sr=SR):
    at.write_wav(str(path), x, sr)
    return str(path)


def _panned(seconds=2.5, seed=41):
    rng = np.random.default_rng(seed)
    base = (rng.standard_normal(int(seconds * SR)) * 0.2).astype(np.float32)
    return np.stack([base * 1.6, base], -1)


@pytest.mark.parametrize("a,b", BOXES + [((0, 300.0), (0, 20000.0))])
def test_measure_pan_matches_jax(a, b):
    x = _panned()
    got = pt.measure_pan(x, SR, a, b, fft_size=512, device="cpu")
    ref = pj.measure_pan(x, SR, a, b, fft_size=512)
    assert got.to_cfg()[:4] == ref.to_cfg()[:4]
    assert got.pan == pytest.approx(ref.pan, rel=1e-5)
    assert got.pan == pytest.approx(1.6, rel=0.05)


def test_apply_pan_matches_jax():
    x = _panned()
    got = pt.apply_pan(x, SR, [mk_t.PanSample(a, b, p) for (a, b), p in zip(BOXES, (0.6, 1.3))],
                       device="cpu")
    ref = pj.apply_pan(x, SR, [mk_j.PanSample(a, b, p) for (a, b), p in zip(BOXES, (0.6, 1.3))])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(pt.apply_pan(x, SR, [], device="cpu"),
                                  pj.apply_pan(x, SR, []))


def test_pan_file_streams_and_matches_jax(tmp_path):
    x = _panned()
    path = _write(tmp_path / "p.wav", x)
    samples = [mk_t.PanSample(a, b, p) for (a, b), p in zip(BOXES, (0.6, 1.3))]
    mem = at.read_file(pt.pan_file(path, samples, stream=False, device="cpu"))[0]
    got = at.read_file(pt.pan_file(path, samples, stream=True, device="cpu"))[0]
    ref = aj.read_file(pj.pan_file(path, [mk_j.PanSample(a, b, p) for (a, b), p in
                                          zip(BOXES, (0.6, 1.3))], stream=True))[0]
    assert got.shape == mem.shape == ref.shape == (len(x), 1)
    np.testing.assert_allclose(got, mem, atol=1e-7)
    np.testing.assert_allclose(got, ref, atol=1e-7)


def test_pan_cli_matches_jax(tmp_path, capsys):
    x = _panned()
    path = _write(tmp_path / "p.wav", x)
    proj = str(tmp_path / "p.pan")
    prj.Project(".pan", {"fft_size": 512, "fft_overlap": 4}, {"markers": [
        mk_j.PanSample(a, b, p) for (a, b), p in zip(BOXES, (0.6, 1.3))]}).save(proj)
    assert [m.to_cfg() for m in prt.Project.load(proj).marker_list("markers")] == \
        [m.to_cfg() for m in prj.Project.load(proj).marker_list("markers")]
    assert cli_j.main(["pan", path, "--project", proj]) == 0
    ref = at.read_file(json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                       ["outputs"][0])[0]
    assert cli_t.main(["pan", path, "--project", proj, "--device", "cpu"]) == 0
    got = at.read_file(json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                       ["outputs"][0])[0]
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,n_valid", [(5000, None), (5011, 4000), (700, 650)])
def test_windowed_rms_matches_jax_and_loop(n, n_valid):
    sig = np.random.default_rng(7).standard_normal(n).astype(np.float32)
    got = dt._windowed_rms_device(torch.from_numpy(sig), 32, 512, n_valid).numpy()
    ref = np.asarray(dj._windowed_rms_device(sig, 32, 512, n_valid))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    m = n if n_valid is None else n_valid
    loop = [np.sqrt(np.mean(np.square(sig[i:min(i + 512, m)], dtype=np.float64)))
            for i in range(0, m, 32)]
    np.testing.assert_allclose(got, loop, rtol=1e-5)
    if n_valid is None:
        np.testing.assert_allclose(dt.windowed_rms(sig, device="cpu"), ref, rtol=1e-6)


def _dynamics(seconds=3.2, seed=51, channels=1):
    n = int(seconds * SR)
    t = np.arange(n) / SR
    rng = np.random.default_rng(seed)
    env_ref = 0.1 + 0.5 * (np.sin(2 * np.pi * 0.5 * t) > 0)
    env_src = 0.3 + 0.1 * (np.sin(2 * np.pi * 0.5 * t) > 0)  # compressed
    carrier = np.sin(2 * np.pi * 1000 * t) + 0.1 * rng.standard_normal(n)
    ref = np.stack([carrier * env_ref] * channels, -1).astype(np.float32)
    src = np.stack([carrier * env_src] * channels, -1).astype(np.float32)
    return src, ref


def _random_dynamics(seconds=4.0, seed=0):
    """A smooth random reference envelope and the source's, compressed to
    its 0.3 power: the envelopes' xcorr has a sharp peak.  (A square
    envelope's xcorr can have a flat top, where two float32 FFTs pick lags
    half a sample apart and ``--sync`` rounds them to different shifts.)"""
    n = int(seconds * SR)
    rng = np.random.default_rng(seed)
    w = SR // 5
    env = np.exp(1.5 * uniform_filter1d(rng.standard_normal(n), w, mode="wrap") * np.sqrt(w))
    env /= env.max()
    carrier = np.sin(2 * np.pi * 1000 * np.arange(n) / SR) + 0.1 * rng.standard_normal(n)
    return ((carrier * 0.3 * env ** 0.3).astype(np.float32)[:, None],
            (carrier * 0.5 * env).astype(np.float32)[:, None])


@pytest.mark.parametrize("do_sync,channels", [(False, 1), (True, 2)])
def test_match_dynamics_matches_jax(do_sync, channels):
    src, ref = _dynamics(channels=channels)
    kw = dict(smoothing_sec=0.05, corr_sz=1024, do_sync=do_sync)
    got = dt.match_dynamics(src, ref, SR, device="cpu", **kw)
    want = dj.match_dynamics(src, ref, SR, **kw)
    assert got.shape == want.shape == src.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    loud, quiet = slice(int(0.3 * SR), int(0.7 * SR)), slice(int(1.3 * SR), int(1.7 * SR))
    ratio = np.sqrt(np.mean(got[loud] ** 2) / np.mean(got[quiet] ** 2))
    assert ratio > 2.5  # the reference's 6x swing, the source's 1.33x


@pytest.mark.parametrize("sync", [False, True])
def test_decompress_file_streams_and_matches_jax(tmp_path, sync):
    src, ref = _dynamics()
    ps, pr = _write(tmp_path / "src.wav", src), _write(tmp_path / "ref.wav", ref)
    kw = dict(do_sync=sync, corr_sz=1024)
    mem = at.read_file(dt.decompress_file(ps, pr, stream=False, device="cpu", **kw))[0]
    got = at.read_file(dt.decompress_file(ps, pr, stream=True, device="cpu", **kw))[0]
    want = aj.read_file(dj.decompress_file(ps, pr, stream=False, **kw))[0]
    want_s = aj.read_file(dj.decompress_file(ps, pr, stream=True, **kw))[0]
    assert got.shape == mem.shape == want.shape == src.shape
    np.testing.assert_allclose(mem, want, atol=1e-5)
    np.testing.assert_allclose(got, want_s, atol=1e-5)
    h = SR // 2
    np.testing.assert_allclose(got[h:-h], mem[h:-h], atol=5e-4)


@pytest.mark.parametrize("extra", [["--hop", "64", "--rms-size", "1024"], ["--sync"]])
def test_decompress_cli_matches_jax(tmp_path, capsys, extra):
    src, ref = _random_dynamics()  # 4 s: --sync's windows are 4096 frames
    ps, pr = _write(tmp_path / "s.wav", src), _write(tmp_path / "r.wav", ref)
    assert cli_j.main(["decompress", ps, pr, *extra]) == 0
    want = aj.read_file(json.loads(capsys.readouterr().out.strip().splitlines()[-1])
                        ["outputs"][0])[0]
    assert cli_t.main(["decompress", ps, pr, *extra, "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"][0]
    assert out.endswith("s_decompressed.wav")
    np.testing.assert_allclose(at.read_file(out)[0], want, atol=1e-5)


def test_cuda_default_raises_without_a_card(tmp_path):
    src, ref = _dynamics(seconds=1.0)
    ps, pr = _write(tmp_path / "s.wav", src), _write(tmp_path / "r.wav", ref)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dt.decompress_file(ps, pr)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pt.pan_file(_write(tmp_path / "p.wav", _panned(1.0)), [])
