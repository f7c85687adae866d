"""The port's portable respeed path against the JAX package on the CPU:
restore_file end to end (the compacted-sample rule and flutter under 0.2x,
tests/test_respeeder.py:36-46), blockwise tracing, .spd replay in memory
and streamed, --save-project, and every form of the respeed CLI."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.pipelines import respeeder as pj
from pyaudiorestoration_tpu.utils import audio_io
from pyaudiorestoration_tpu_torch import cli
from pyaudiorestoration_tpu_torch.pipelines import respeeder as pt
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import audio_io as port_io
from pyaudiorestoration_tpu_torch.utils import project
from tests.test_respeeder import make_wow_tone, tone_stability

torch.set_num_threads(2)

SR = 16000
KW = dict(fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=16)


def _assert_compacted_close(a, b):
    assert abs(len(a) - len(b)) <= 2
    m = min(len(a), len(b)) - 100
    err = np.abs(a[100:m] - b[100:m])
    assert np.median(err) < 1e-4, np.median(err)
    assert (err > 1e-2).mean() < 0.01


@pytest.fixture()
def wow(tmp_path):
    sig = make_wow_tone(sr=SR, duration=2.5, f0=2000.0)
    path = tmp_path / "wow.wav"
    audio_io.write_wav(path, np.stack([sig, 0.6 * sig], -1), SR)
    return str(path), sig


# the peak trackers give JAX's curve to the ulp; the centre of gravity's
# float32 band sums add in another order than XLA's (~7e-7 relative in its
# frequencies), which the plan accumulates past the compacted-sample rule
@pytest.mark.parametrize("mode,adapt", [("Peak", "None"), ("Peak", "Linear"),
                                        ("Peak Track", "None")])
def test_restore_file_matches_jax(wow, tmp_path, mode, adapt):
    path, sig = wow
    src_j = str(tmp_path / "j.wav")
    shutil.copy(path, src_j)
    out_t = pt.restore_file(path, mode=mode, adapt=adapt, device="cpu", **KW)
    out_j = pj.restore_file(src_j, mode=mode, adapt=adapt, **KW)
    a, sr, ch = audio_io.read_file(out_t[0])
    b, _, _ = audio_io.read_file(out_j[0])
    assert out_t == [str(tmp_path / "wow_res.wav")] and sr == SR and ch == 2
    for c in range(2):
        _assert_compacted_close(a[:, c], b[:, c])
    assert tone_stability(a[:, 0].astype(float), SR) < 0.2 * tone_stability(
        sig.astype(float), SR)


def test_restore_file_cog_reduces_flutter(wow, tmp_path):
    path, sig = wow
    src_j = str(tmp_path / "j.wav")
    shutil.copy(path, src_j)
    a, _, _ = audio_io.read_file(pt.restore_file(path, mode="Center of Gravity",
                                                 device="cpu", **KW)[0])
    b, _, _ = audio_io.read_file(pj.restore_file(src_j, mode="Center of Gravity", **KW)[0])
    assert abs(len(a) - len(b)) <= 2
    assert np.median(np.abs(a[100:-100, 0] - b[100:-100, 0])) < 1e-3
    assert tone_stability(a[:, 0].astype(float), SR) < 0.2 * tone_stability(
        sig.astype(float), SR)


def test_restore_file_blockwise_matches_jax(wow, tmp_path):
    path, sig = wow
    src_j = str(tmp_path / "j.wav")
    shutil.copy(path, src_j)
    kw = dict(KW, blockwise=64, trail=[(0.0, 2000.0), (2.5, 2000.0)])
    a, _, _ = audio_io.read_file(pt.restore_file(path, device="cpu", **kw)[0])
    b, _, _ = audio_io.read_file(pj.restore_file(src_j, **kw)[0])
    _assert_compacted_close(a[:, 0], b[:, 0])
    assert tone_stability(a[:, 0].astype(float), SR) < 0.2 * tone_stability(
        sig.astype(float), SR)


def test_save_project_and_replay(wow, tmp_path):
    """--save-project writes the JAX package's .spd bytes; run_project
    replays it in memory and through the streamed tier."""
    path, sig = wow
    src_j = str(tmp_path / "j.wav")
    shutil.copy(path, src_j)
    out = pt.restore_file(path, save_project=True, suffix="_a", device="cpu", **KW)
    pj.restore_file(src_j, save_project=True, suffix="_a", **KW)
    spd_t, spd_j = str(tmp_path / "wow.spd"), str(tmp_path / "j.spd")
    # the same settings and one traced line, its frequencies within the
    # trackers' rtol (the files cross byte for byte on equal markers,
    # tests/test_torch_markers_project.py)
    doc_t, doc_j = (json.load(open(p)) for p in (spd_t, spd_j))
    assert doc_t.pop("source") == path and doc_j.pop("source") == src_j
    (t_t, f_t, o_t), = doc_t.pop("lines")
    (t_j, f_j, o_j), = doc_j.pop("lines")
    assert doc_t == doc_j and t_t == t_j and o_t == o_j == 0.0
    np.testing.assert_allclose(f_t, f_j, rtol=2e-4)
    assert project.Project.load(spd_t).marker_list("lines")

    mem = pt.run_project(spd_t, out_suffix="_mem", stream=False, device="cpu")
    a, _, _ = audio_io.read_file(mem[0])
    np.testing.assert_array_equal(a, audio_io.read_file(out[0])[0])
    ref = pj.run_project(spd_j, out_suffix="_mem", stream=False)
    _assert_compacted_close(a[:, 0], audio_io.read_file(ref[0])[0][:, 0])

    streamed = pt.run_project(spd_t, out_suffix="_str", stream=True, device="cpu")
    b, _, ch = audio_io.read_file(streamed[0])
    assert ch == 2 and abs(len(b) - len(sig)) < 0.01 * len(sig)
    assert tone_stability(b[:, 0].astype(float), SR) < 0.2 * tone_stability(
        sig.astype(float), SR)
    ref = pj.run_project(spd_j, out_suffix="_str", stream=True)
    _assert_compacted_close(b[:, 0], audio_io.read_file(ref[0])[0][:, 0])


def test_regression_markers_drive_the_curve(wow, tmp_path):
    path, _ = wow
    lines = [pt.trace_trail(audio_io.read_file(path)[0], SR, [(0, 2000.0), (2.5, 2000.0)],
                            device="cpu", **{k: KW[k] for k in ("fft_size", "fft_overlap",
                                                                 "zeropad")})]
    regs = [pt.mk.RegLine(0.0, 2.5, 0.02, 2 * np.pi * 0.6, 0.0, 0.0)]
    curve = pt.get_speed_curve(lines, regs, SR, 256, 2.5)
    ref = pj.get_speed_curve([pj.mk.TraceLine(lines[0].times, lines[0].freqs)],
                             [pj.mk.RegLine(0.0, 2.5, 0.02, 2 * np.pi * 0.6, 0.0, 0.0)],
                             SR, 256, 2.5)
    assert np.array_equal(curve, ref)
    merged = pt.merge_traces(lines, pt.get_speed_curve(lines, [], SR, 256, 2.5), SR, 256)
    assert len(merged.times) > 10


def _run_cli(argv, capsys):
    try:
        rc = cli.main(argv)
    finally:
        port_io.set_output_format("wav")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]


@pytest.mark.parametrize("extra", [
    [],
    ["--mode", "Peak Track"],
    ["--mode", "Center of Gravity"],
    ["--mode", "Zero-Crossing"],
    ["--mode", "Correlation"],
    ["--mode", "Freehand Draw", "--trail", "0", "2000", "2.5", "2000"],
    ["--mode", "Peak", "--adaptation", "Average", "--trail", "0", "2000", "2.5", "2000"],
    ["--resampling-mode", "Linear"],
])
def test_cli_respeed_modes_on_cpu(wow, capsys, extra):
    path, sig = wow
    outs = _run_cli(["respeed", path, "--device", "cpu", "--fft-size", "2048",
                     "--zeropad", "2", "--sinc-quality", "16", *extra], capsys)
    y, sr, ch = audio_io.read_file(outs[0])
    assert sr == SR and ch == 2 and np.all(np.isfinite(y))
    assert abs(len(y) - len(sig)) < 0.02 * len(sig)


def test_cli_respeed_spd_stream_and_flac(wow, tmp_path, capsys):
    path, sig = wow
    base = ["--device", "cpu", "--fft-size", "2048", "--zeropad", "2",
            "--sinc-quality", "16"]
    _run_cli(["respeed", path, "--save-project", "--suffix", "_p", *base], capsys)
    spd = str(tmp_path / "wow.spd")
    assert os.path.isfile(spd)
    replay = _run_cli(["respeed", spd, "--device", "cpu", "--suffix", "_replay"], capsys)
    assert replay == [str(tmp_path / "wow_res_replay.wav")]
    np.testing.assert_array_equal(audio_io.read_file(replay[0])[0],
                                  audio_io.read_file(str(tmp_path / "wow_res_p.wav"))[0])
    streamed = _run_cli(["--flac-out", "16", "respeed", path, "--stream", "--suffix", "_s",
                         *base], capsys)
    assert streamed == [str(tmp_path / "wow_res_s.flac")]
    y, sr, ch = audio_io.read_file(streamed[0])
    assert ch == 2 and abs(len(y) - len(sig)) < 0.01 * len(sig)
    mem = rt.restore_file_fast(path, suffix="_m", stream=False, device="cpu", **{
        k: KW[k] for k in ("zeropad", "sinc_quality")}, fft_size=2048)
    np.testing.assert_allclose(y, audio_io.read_file(mem)[0], atol=2.0 / (1 << 15))
    fast = _run_cli(["--flac-out", "--flac-fast", "respeed", path, "--fast",
                     "--suffix", "_f", *base], capsys)
    assert fast[0].endswith("_res_f.flac")
