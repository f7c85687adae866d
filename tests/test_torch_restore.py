"""The port's slice as a whole against the JAX package on the CPU:
compaction, restore_device, restore_file_fast, the CLI, and the rule that
the port imports no JAX and never falls back from CUDA to the CPU."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.pipelines import respeeder_device as rj
from pyaudiorestoration_tpu.utils import audio_io
from pyaudiorestoration_tpu_torch import cli
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch
from tests.test_respeeder import tone_stability
from tests.test_torch_cli_errors import error_exit, jax_argv

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stereo_wow(sr=22050, seconds=2.5, f0=3000.0):
    """test_restore_file_fast.py's take: a wow tone and its octave below."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    speed = 1.0 + 0.02 * np.sin(2 * np.pi * 0.8 * t)
    phase = 2 * np.pi * f0 * np.cumsum(speed) / sr
    left = (np.sin(phase) * 0.5).astype(np.float32)
    right = (np.sin(phase * 0.5) * 0.4).astype(np.float32)
    return np.stack([left, right], -1), sr


def _assert_compacted_close(a, b):
    """test_restore_fused.py:88-96: dither boundaries may fall a sample
    apart in rare segments, so hold the median and the share of outliers."""
    assert abs(len(a) - len(b)) <= 2
    m = min(len(a), len(b)) - 100
    err = np.abs(a[100:m] - b[100:m])
    assert np.median(err) < 1e-4, np.median(err)
    assert (err > 1e-2).mean() < 0.01


@pytest.mark.parametrize("channels", [None, 2])
def test_compact_padded_device_bit_equal(channels):
    rng = np.random.default_rng(0)
    T, max_n = 300, 37
    n = rng.integers(20, max_n + 1, T).astype(np.int32)
    n[[0, 5, 6, 7, 150, T - 1]] = 0  # zero-count segments, incl. first and last
    shape = (T, max_n) if channels is None else (channels, T, max_n)
    padded = rng.standard_normal(shape).astype(np.float32)
    for out_len in (int(n.sum()), int(n.sum()) - 250):
        ref, ref_n = rj.compact_padded_device(jnp.asarray(padded), jnp.asarray(n), out_len)
        got, got_n = rt.compact_padded_device(torch.from_numpy(padded),
                                              torch.from_numpy(n), out_len)
        assert got.dtype == torch.float32 and int(got_n) == int(ref_n)
        assert np.array_equal(got.numpy(), np.asarray(ref))


def test_restore_device_sinc_stage_on_jax_plan():
    """The port's resampling stage fed the JAX plan and speed curve
    reproduces JAX's padded grid; the port's own restore_device meets the
    compacted-sample criterion against it."""
    sr, f0 = 22050, 3000.0
    x = _stereo_wow(sr)[0][:, 0]
    kw = dict(fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=30)
    padded_j, plan_j = rj.restore_device(jnp.asarray(x), sr, f0, **kw)
    padded_j = np.asarray(padded_j)

    hop = kw["fft_size"] // kw["fft_overlap"]
    NL, NU = rj._band_limits(f0, 1.0, kw["fft_size"], kw["zeropad"], sr)
    n_frames = len(x) // hop + 1
    speeds_j = np.array(rj.track_speed_device(
        jnp.asarray(x), jnp.full((n_frames,), NL, jnp.int32),
        jnp.full((n_frames,), NU, jnp.int32), kw["fft_size"], hop,
        kw["zeropad"], band=(NL - 1, NU + 1)))
    p = plan_to_torch(plan_j, "cpu")
    got = rt.run_banded_sinc(torch.from_numpy(x), torch.from_numpy(speeds_j),
                             p["n"], p["base_int"], p["base_frac"], p["max_n"],
                             kw["sinc_quality"], rt._drift_bucket(p["drift"])).numpy()
    np.testing.assert_allclose(got, padded_j, atol=3e-5, rtol=0)

    padded_t, plan_t = rt.restore_device(x, sr, f0, device="cpu", **kw)
    _assert_compacted_close(rt.compact_output(padded_t.numpy(), plan_t),
                            rj.compact_output(padded_j, plan_j))


def test_restore_file_fast_matches_jax(tmp_path):
    sig, sr = _stereo_wow()
    src_j, src_t = tmp_path / "j.wav", tmp_path / "t.wav"
    audio_io.write_wav(src_j, sig, sr)
    shutil.copy(src_j, src_t)
    kw = dict(fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=30)
    out_j, _, _ = audio_io.read_file(rj.restore_file_fast(str(src_j), **kw))
    path_t = rt.restore_file_fast(str(src_t), device="cpu", **kw)
    assert path_t == str(tmp_path / "t_res.wav")
    out_t, osr, ch = audio_io.read_file(path_t)
    assert ch == 2 and osr == sr
    for c in range(2):
        _assert_compacted_close(out_t[:, c], out_j[:, c])
        before = tone_stability(sig[:, c].astype(float), sr)
        assert tone_stability(out_t[:, c].astype(float), sr) < 0.2 * before


@pytest.mark.parametrize("use_channels", [[0], [1, 0]])
def test_restore_file_fast_tracking_channel_matches_jax(tmp_path, use_channels):
    """Tracking on channel 1, whether it is exported (and so reused from the
    uploaded channels) or not (and so uploaded on its own)."""
    sig, sr = _stereo_wow(seconds=2.0)
    src_j, src_t = tmp_path / "j.wav", tmp_path / "t.wav"
    audio_io.write_wav(src_j, sig, sr)
    shutil.copy(src_j, src_t)
    kw = dict(fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=16,
              channel=1, use_channels=use_channels)
    out_j, _, ch_j = audio_io.read_file(rj.restore_file_fast(str(src_j), **kw))
    out_t, _, ch_t = audio_io.read_file(
        rt.restore_file_fast(str(src_t), device="cpu", **kw))
    assert ch_t == ch_j == len(use_channels)
    for c in range(ch_t):
        _assert_compacted_close(out_t[:, c], out_j[:, c])


def test_cli_respeed_fast_on_cpu(tmp_path, capsys):
    sig, sr = _stereo_wow(seconds=2.0)
    src = tmp_path / "take.wav"
    audio_io.write_wav(src, sig, sr)
    rc = cli.main(["respeed", "--fast", str(src), "--device", "cpu",
                   "--fft-size", "2048", "--zeropad", "2", "--sinc-quality", "16",
                   "--suffix", "_cli"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert out == [str(tmp_path / "take_res_cli.wav")] and os.path.isfile(out[0])
    res, osr, ch = audio_io.read_file(out[0])
    assert ch == 2 and osr == sr and abs(len(res) - len(sig)) < 0.01 * len(sig)


@pytest.mark.parametrize("argv", [["respeed-batch", "take.wav", "--tier", "fixed"],
                                  ["respeed-batch", "a.wav", "b.wav", "--tier", "fixed",
                                   "--f0", "1000"],
                                  ["respeed-batch", "take.wav", "--tier", "fixed",
                                   "--device", "cpu"]])
def test_cli_paths_not_ported_exit_clearly(argv, capsys):
    """Every form of respeed is ported, and respeed-batch's fixed-length
    tier too: without --f0 it exits 1 with the one error line that JAX's
    CLI prints for the same argv; with it and no card, the default device
    raises that torch sees none."""
    if "--f0" not in argv:
        want = error_exit(cli_j.main, jax_argv(argv), capsys)
        assert want == (1, ["error: --tier fixed requires --f0"])
        assert error_exit(cli.main, argv, capsys) == want
    elif not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(argv)
    assert "not ported yet" not in capsys.readouterr().err


def test_streamed_tier_raises_not_implemented(tmp_path, monkeypatch):
    """The streamed tier is ported: a forced stream, or a decoded size over
    the threshold, no longer raises but routes to restore_file_streamed,
    which writes the output."""
    src = tmp_path / "s.wav"
    audio_io.write_wav(src, _stereo_wow(seconds=0.5)[0], 22050)
    calls = []
    real = rt.restore_file_streamed
    monkeypatch.setattr(rt, "restore_file_streamed",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    kw = dict(fft_size=2048, zeropad=2, sinc_quality=8, device="cpu")
    for i, extra in enumerate([dict(stream=True), dict(stream_threshold_bytes=1000)]):
        out = rt.restore_file_fast(str(src), suffix=f"_{i}", **kw, **extra)
        assert len(calls) == i + 1 and os.path.isfile(out)
        assert audio_io.read_file(out)[2] == 2


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rt.restore_device(np.zeros(4096, np.float32), 8000, 440.0)
    with pytest.raises(ValueError):
        rt.restore_device(np.zeros(4096, np.float32), 8000, 440.0, device="meta")


def test_port_runs_without_importing_jax(tmp_path):
    """Every module of the port imports, and the CLI runs each form of
    respeed (device path, streamed tier, a portable tracker with its .spd
    saved, the .spd replay) in a fresh interpreter, without JAX ever being
    imported."""
    src = tmp_path / "take.wav"
    audio_io.write_wav(src, _stereo_wow(seconds=1.0)[0], 22050)
    code = (
        "import sys\n"
        "from pyaudiorestoration_tpu_torch import cli\n"
        "import pyaudiorestoration_tpu_torch.pipelines.respeeder_device\n"
        "import pyaudiorestoration_tpu_torch.kernels.sinc_banded\n"
        "import pyaudiorestoration_tpu_torch.parallel.batch\n"
        "import pyaudiorestoration_tpu_torch.ops.fourier\n"
        "import pyaudiorestoration_tpu_torch.ops.correlation\n"
        "import pyaudiorestoration_tpu_torch.ops.filters\n"
        "import pyaudiorestoration_tpu_torch.ops.resampling\n"
        "import pyaudiorestoration_tpu_torch.models.trackers\n"
        "import pyaudiorestoration_tpu_torch.models.markers\n"
        "import pyaudiorestoration_tpu_torch.utils.project\n"
        "import pyaudiorestoration_tpu_torch.pipelines.respeeder\n"
        f"rc = cli.main(['respeed', '--fast', {str(src)!r}, '--device', 'cpu',"
        " '--fft-size', '2048', '--zeropad', '2', '--sinc-quality', '8'])\n"
        "assert rc == 0, rc\n"
        f"rc = cli.main(['respeed', {str(src)!r}, '--device', 'cpu', '--stream',"
        " '--fft-size', '2048', '--zeropad', '2', '--sinc-quality', '8'])\n"
        "assert rc == 0, rc\n"
        f"rc = cli.main(['respeed', {str(src)!r}, '--device', 'cpu', '--mode',"
        " 'Zero-Crossing', '--sinc-quality', '8', '--save-project'])\n"
        "assert rc == 0, rc\n"
        f"rc = cli.main(['respeed', {str(src)[:-4] + '.spd'!r}, '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('NO_JAX_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert "NO_JAX_OK" in r.stdout, r.stdout + r.stderr
