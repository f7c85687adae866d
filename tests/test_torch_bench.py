"""The port's ``bench`` on the CPU: the plan's parameters are bench.py's
(bench.py:74-95), on the synthesized take and on a tiled FLAC; both tiers
at a tiny size return bench.py's lines with the port's added fields, the
batch's row 0 equal to its solo run and the flutter check applied; the
fused take matches JAX's on bench.py's parameters; and without a card the
bench exits 3 with one stderr line and no metric line, timing nothing."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.pipelines import respeeder_device as rj
from pyaudiorestoration_tpu_torch import bench
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import audio_io
from pyaudiorestoration_tpu_torch.utils import doctor
from pyaudiorestoration_tpu_torch.utils.synth import wow_take

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SECONDS = 0.5
# bench.py's fields in its order (bench.py:160-181), then the port's
FIELDS = ["metric", "value", "unit", "vs_baseline", "x_realtime_serialized",
          "runs_serialized_x_realtime", "pipelined_sets_x_realtime", "wall_cold_s",
          "audio_s"]
ADDED = ["device", "input", "backend", "k1_launches_per_call", "flutter_before",
         "flutter_after"]


def _bench_py_params(mono, sr):
    """bench.py:74-95, line for line."""
    probe = mono[: 1 << 18]
    spec = np.abs(np.fft.rfft(probe * np.hanning(len(probe))))
    f0 = float(np.argmax(spec[10:]) + 10) / len(probe) * sr
    fft_size, overlap, zp = 4096, 8, 2
    hop = fft_size // overlap
    n = len(mono)
    tol = 1.0 / 12
    num_bins = fft_size * zp // 2 + 1
    NL = max(1, min(num_bins - 1, int(round(max(1.0, f0 * 2 ** -tol) * fft_size * zp / sr))))
    NU = max(1, min(num_bins - 1, int(round(min(sr / 2, f0 * 2 ** tol) * fft_size * zp / sr))))
    n_frames = (n + (fft_size // 2) * 2 - fft_size) // hop + 1
    return {"f0": f0, "NL": NL, "NU": NU, "n_frames": n_frames, "hop": hop,
            "max_n": int(hop * 1.1), "band": (NL - 1, NU + 1)}


def _check_params(mono, sr):
    got = bench.plan_params(mono, sr)
    assert got == _bench_py_params(mono, sr)
    # the same pilot and band as the JAX package's own helpers
    assert got["f0"] == rj._probe_f0(mono, sr)
    assert (got["NL"], got["NU"]) == rj._band_limits(got["f0"], 1.0, 4096, 2, sr)
    assert got["max_n"] == 563 and got["n_frames"] == len(mono) // 512 + 1
    return got


def test_plan_params_of_the_synthesized_take(monkeypatch):
    monkeypatch.setattr(bench, "SAMPLE", None)
    mono, sr, name = bench.load_take(2.0)
    assert sr == 192000 and mono.dtype == np.float32 and mono.shape == (2 * sr,)
    assert name.startswith("synthesized wow_take(192000, 2 s")
    got = _check_params(mono, sr)
    assert abs(got["f0"] - 3150.0) < 0.01 * 3150.0  # the pilot, within its 0.8 % wow


def test_plan_params_of_a_tiled_sample(tmp_path, monkeypatch):
    sr = 48000
    t = np.arange(int(0.3 * sr)) / sr
    x = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    path = tmp_path / "pilot.flac"
    audio_io.write_flac(str(path), np.stack([x, 0.5 * x], -1).astype(np.float32), sr)
    monkeypatch.setattr(bench, "SAMPLE", str(path))
    mono, got_sr, name = bench.load_take(1.0)
    sig, _, _ = audio_io.read_file(str(path))
    reps = int(1.0 * sr / len(sig))  # bench.py:68
    assert reps == 3 and got_sr == sr and name == "pilot.flac x3"
    np.testing.assert_array_equal(mono, np.tile(sig[:, 0], reps))
    got = _check_params(mono, sr)
    assert abs(got["f0"] - 1000.0) < 2 * sr / len(mono[: 1 << 18])  # two bins


def test_both_tiers_on_the_cpu(monkeypatch):
    """Both line dicts, every field in order, at 0.5 s with k_pipe 1 and one
    set; the batch's row 0 equal to its solo run (the bench holds it within
    1e-6 and so does this test, from the same tensors); the flutter
    checked.  On the CPU the wrappers run their plain versions: K1 launches
    0 a call."""
    monkeypatch.setattr(bench, "SAMPLE", None)
    mono, sr, name = bench.load_take(SECONDS)
    seen = {}
    takes, fused = rt.restore_fused_takes, rt.restore_fused_device

    def spy_takes(*a, **k):
        return seen.setdefault("takes", takes(*a, **k))

    def spy_fused(xb, *a, **k):
        out = fused(xb, *a, **k)
        seen["solo"] = out  # the last single-take call is the batch row 0's solo run
        return out

    monkeypatch.setattr(rt, "restore_fused_takes", spy_takes)
    monkeypatch.setattr(rt, "restore_fused_device", spy_fused)
    first, second = bench.run_tiers(mono, sr, "cpu", name, k_pipe=(1, 1),
                                    n_serial=(1, 1), n_sets=1)
    assert list(first) == FIELDS + ["batch8_x_realtime"] + ADDED
    assert list(second) == FIELDS + ADDED
    assert "PyTorch port, 1 CUDA card" in first["metric"]
    assert first["metric"] != second["metric"]
    for line, audio_s in ((first, SECONDS), (second, 8 * SECONDS)):
        assert line["unit"] == "x_realtime" and line["audio_s"] == audio_s
        assert line["vs_baseline"] == round(line["value"] / 100.0, 3)
        assert abs(line["value"] - max(line["pipelined_sets_x_realtime"])) <= 0.05
        assert len(line["runs_serialized_x_realtime"]) == 1
        assert len(line["pipelined_sets_x_realtime"]) == 1
        assert line["device"] == {"name": "cpu", "power_limit_w": None, "count": 0}
        assert line["input"] == name and line["backend"] == "xla"
        assert line["k1_launches_per_call"] == 0
        assert line["flutter_after"] < bench.FLUTTER_DROP * line["flutter_before"]
    assert first["batch8_x_realtime"] == second["value"]
    assert seen["takes"].shape[0] == 8
    assert float((seen["takes"][0] - seen["solo"]).abs().max()) <= bench.ROW0_TOL
    json.dumps([first, second])


def test_a_failed_check_reports_no_speed(monkeypatch):
    monkeypatch.setattr(bench, "SAMPLE", None)
    monkeypatch.setattr(bench, "FLUTTER_DROP", 0.0)
    mono, sr, name = bench.load_take(SECONDS)
    with pytest.raises(bench.CheckFailed, match="single take: flutter"):
        bench.run_tiers(mono, sr, "cpu", name, k_pipe=(1, 1), n_serial=(1, 1), n_sets=1)


def _compacted(padded, n):
    k = np.arange(padded.shape[-1])[None, :]
    return padded[k < np.asarray(n)[:, None]]


def test_fused_take_matches_jax_at_bench_parameters():
    """bench.py's single tier (zeropad 2, quality 50, drift 16, stereo) on
    the 0.5 s take: the port's restore_fused_device against JAX's
    (``backend="xla"``) by tests/test_restore_fused.py:88-96's rule, each
    channel compacted by its own package's plan."""
    sr = 192000
    mono = wow_take(sr, SECONDS)[:, 0]
    p = bench.plan_params(mono, sr)
    args = (4096, p["hop"], 2, p["max_n"], 50, 16)
    x = np.stack([mono, mono * 0.8])
    NL = np.full((p["n_frames"],), p["NL"], np.int32)
    NU = np.full((p["n_frames"],), p["NU"], np.int32)
    got = rt.restore_fused_device(x, NL, NU, *args, band=p["band"], device="cpu").numpy()
    n_t = rt._fused_plan(torch.as_tensor(mono), torch.as_tensor(NL), torch.as_tensor(NU),
                         *args, "blackmanharris", p["band"])[1].numpy()
    want = np.asarray(rj.restore_fused_device(jnp.asarray(x), jnp.asarray(NL),
                                              jnp.asarray(NU), *args, backend="xla",
                                              band=p["band"]))
    n_j = np.asarray(rj._fused_plan(jnp.asarray(mono), jnp.asarray(NL), jnp.asarray(NU),
                                    *args, "blackmanharris", p["band"])[1])
    assert got.shape == want.shape == (2, p["n_frames"] - 1, p["max_n"])
    for c in range(2):
        a, b = _compacted(got[c], n_t), _compacted(want[c], n_j)
        m = min(len(a), len(b)) - 100
        err = np.abs(a[100:m] - b[100:m])
        assert abs(len(a) - len(b)) <= 2
        assert np.median(err) < 1e-4
        assert (err > 1e-2).mean() < 0.01


def test_main_never_times_on_the_cpu(monkeypatch, capsys):
    """Even past a probe that says ok, the tiers run on the card only: here,
    with no card, resolving it raises before any timing, and stdout stays
    empty."""
    monkeypatch.setattr(doctor, "_probe_devices", lambda timeout_s: (
        "ok", {"tiny_op_ok": True, "k1_ok": True}))
    monkeypatch.setattr(bench, "SAMPLE", None)
    monkeypatch.setenv("BENCH_SECONDS", str(SECONDS))
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would time on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_bench_without_a_card_exits_3():
    """The probe's child finds no card: one stderr line, no JSON line, exit
    3, as bench.py exits where its device runtime is unavailable."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-m", "pyaudiorestoration_tpu_torch", "bench"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 3
    assert r.stdout == ""
    lines = r.stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("bench: device runtime unavailable")
    assert "torch sees no CUDA card" in lines[0]
