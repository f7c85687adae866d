"""The port's metrics, spectrum cache, undo stack and config against the
JAX package on the CPU: ``flutter`` and ``snr_db`` equal to the bit,
``spectral_distance_db`` within 1e-3 dB, ``measure_files`` the same JSON
(errors and ``None`` for identical files included); the cache's stride
reuse, ``get_or_compute`` and ``.npz`` files read by either package; each
undo action leaving the same markers in both; the config round trip."""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from pyaudiorestoration_tpu import cli as cli_j
from pyaudiorestoration_tpu.models import markers as mk_j
from pyaudiorestoration_tpu.utils import cache as cache_j
from pyaudiorestoration_tpu.utils import config as cfg_j
from pyaudiorestoration_tpu.utils import metrics as met_j
from pyaudiorestoration_tpu.utils import undo as undo_j
from pyaudiorestoration_tpu_torch import cli as cli_t
from pyaudiorestoration_tpu_torch.models import markers as mk_t
from pyaudiorestoration_tpu_torch.utils import cache as cache_t
from pyaudiorestoration_tpu_torch.utils import config as cfg_t
from pyaudiorestoration_tpu_torch.utils import metrics as met_t
from pyaudiorestoration_tpu_torch.utils import undo as undo_t

torch.set_num_threads(2)
SR = 16000


def _wow_tone(seconds=3.0, depth=0.004, seed=0, noise=1e-3):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    speed = 1 + depth * np.sin(2 * np.pi * 0.7 * t)
    x = 0.5 * np.sin(2 * np.pi * 1000 * np.cumsum(speed) / SR)
    x = x + noise * rng.standard_normal(len(t))
    return np.stack([x, 0.7 * x], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0.0, 0.004, 0.02])
def test_flutter_equals_jax(depth):
    x = _wow_tone(depth=depth)
    assert met_t.flutter(x, SR) == met_j.flutter(x, SR)
    assert met_t.flutter(x[:, 1], SR, smooth_periods=8) == met_j.flutter(x[:, 1], SR, 8)
    for f in (met_t.flutter, met_j.flutter):
        with pytest.raises(ValueError, match="zero crossings"):
            f(np.ones(1000), SR)


def test_snr_equals_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(5000)
    for b in (a + 0.01 * rng.standard_normal(5000), a[:4000] * 0.5, a):
        assert met_t.snr_db(a, b) == met_j.snr_db(a, b)
    assert met_t.snr_db(a, a) == float("inf")


@pytest.mark.parametrize("case", ["self", "gain", "noise", "lengths"])
def test_spectral_distance_matches_jax(case):
    a = _wow_tone(2.0)
    b = {"self": a, "gain": 0.5 * a, "noise": _wow_tone(2.0, seed=3, noise=0.05),
         "lengths": _wow_tone(1.5, depth=0.01)}[case]
    want = met_j.spectral_distance_db(a, b, SR)
    got = met_t.spectral_distance_db(a, b, SR, device="cpu")
    assert abs(got - want) <= 1e-3, (got, want)
    if case == "self":
        assert got == 0.0


@pytest.fixture
def files(tmp_path):
    """Two related takes, a copy, one at another rate and a toneless one."""
    paths = {}
    for name, x, sr in (("a", _wow_tone(), SR), ("b", _wow_tone(seed=1, depth=0.001), SR),
                        ("c", _wow_tone(), SR), ("d", _wow_tone(), 8000),
                        ("e", np.full((800, 2), 0.25, np.float32), SR)):
        paths[name] = str(tmp_path / f"{name}.wav")
        wavfile.write(paths[name], sr, x)
    return paths


@pytest.mark.parametrize("args", [["a", "b"], ["a", "c"], ["a"], ["e", "a"],
                                  ["a", "b", "--metric", "flutter"],
                                  ["a", "b", "--metric", "snr"],
                                  ["a", "b", "--metric", "spectral"]])
def test_measure_cli_matches_jax(files, capsys, args):
    argv = ["measure"] + [files.get(a, a) for a in args]
    assert cli_j.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert cli_t.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    got_d, want_d = json.loads(got), json.loads(want)
    assert got_d.keys() == want_d.keys()
    if "spectral_distance_db" in want_d:
        assert abs(got_d.pop("spectral_distance_db")
                   - want_d.pop("spectral_distance_db")) <= 1e-3
    assert got_d == want_d
    if args == ["a", "c"]:
        assert want_d["snr_db"] is None and "Infinity" not in got


@pytest.mark.parametrize("args,match", [(("a", None, "snr"), "needs a second file"),
                                        (("a", None, "spectral"), "needs a second file"),
                                        (("a", "d", "all"), "sample rates differ")])
def test_measure_files_errors_match_jax(files, args, match):
    a, b, metric = args
    for fn, kw in ((met_j.measure_files, {}), (met_t.measure_files, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            fn(files[a], files.get(b), metric, **kw)


def test_measure_files_raises_without_a_card(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        met_t.measure_files(files["a"], files["b"])


# ---------------------------------------------------------------------------
# spectrum cache
# ---------------------------------------------------------------------------

def test_cache_stride_reuse():
    rng = np.random.default_rng(4)
    c = cache_t.SpectrumCache(device="cpu")
    spec_dense = rng.standard_normal((65, 100)).astype(np.float32)
    c.store(128, 0, 16, 1, spec_dense)
    got = c.lookup(128, 0, 32, 1)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), spec_dense[:, ::2])
    assert (128, 0, 32, 1) in c.storage  # the decimated entry is kept
    assert c.lookup(128, 0, 40, 1) is None  # 40 % 16 != 0 -> not serveable
    assert c.lookup(256, 0, 16, 1) is None  # different fft size
    assert c.lookup(128, 1, 32, 1) is None  # different channel
    c.clear()
    assert c.lookup(128, 0, 16, 1) is None


def test_cache_get_or_compute_matches_jax():
    sig = _wow_tone(1.0)
    c_t = cache_t.SpectrumCache(device="cpu")
    c_j = cache_j.SpectrumCache()
    calls = []

    def compute(s):
        calls.append(1)
        return torch.ones(3, 4)

    assert c_t.get_or_compute(sig, 256, 5, 64, 1, compute) is c_t.get_or_compute(
        sig, 256, 5, 64, 1, compute)
    assert len(calls) == 1
    for ch, zp in ((0, 1), (1, 2)):
        got = c_t.get_or_compute(sig, 256, ch, 64, zp)
        want = np.asarray(c_j.get_or_compute(sig, 256, ch, 64, zp))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # a denser hop serves a sparser request in both
    np.testing.assert_allclose(c_t.get_or_compute(sig, 256, 0, 128, 1).numpy(),
                               np.asarray(c_j.get_or_compute(sig, 256, 0, 128, 1)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cache_files_read_by_either_package(tmp_path, writer):
    audio = str(tmp_path / "take.wav")
    spec = np.abs(np.random.default_rng(5).standard_normal((129, 50))).astype(np.float32)
    if writer == "jax":
        cache_j.SpectrumCache(audio, persist=True).store(256, 0, 64, 2, spec)
    else:
        cache_t.SpectrumCache(audio, persist=True, device="cpu").store(
            256, 0, 64, 2, torch.as_tensor(spec))
    assert (tmp_path / "take.fft_256_0_64_2.npz").is_file()
    got_t = cache_t.SpectrumCache(audio, persist=True, device="cpu").lookup(256, 0, 64, 2)
    got_j = cache_j.SpectrumCache(audio, persist=True).lookup(256, 0, 64, 2)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(got_t.numpy(), spec)
    np.testing.assert_array_equal(np.asarray(got_j), spec)
    # without persistence nothing is read
    assert cache_t.SpectrumCache(audio, device="cpu").lookup(256, 0, 64, 2) is None


def test_cache_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cache_t.SpectrumCache()


# ---------------------------------------------------------------------------
# undo stack
# ---------------------------------------------------------------------------

def _edits(mk, undo):
    """The same marker edits on one package's markers: after each push,
    undo and redo, the markers' configs."""
    t = np.linspace(0.0, 1.0, 10)
    l1 = mk.TraceLine(t, np.full(10, 440.0))
    l2 = mk.TraceLine(t + 0.5, np.full(10, 445.0))
    merged = mk.TraceLine(t + 0.2, np.full(10, 442.0))
    lag1 = mk.LagSample((0.5, 100.0), (1.0, 2000.0), 0.01)
    lag2 = mk.LagSample((1.5, 100.0), (2.0, 2000.0), -0.02)
    states = []
    stack = undo.UndoStack(on_change=lambda m: states.append("changed"))

    def snap():
        states.append([(type(m).__name__, np.asarray(m.to_cfg(), dtype=object).tolist())
                       for m in stack.markers])

    for action in (undo.AddAction([l1, l2, lag1, lag2]),
                   undo.MoveAction([l1], 0.0, 0.25),
                   undo.DeltaAction([lag1, lag2], [0.003, -0.001]),
                   undo.MergeAction([merged], [l1, l2]),
                   undo.DeleteAction([lag2])):
        stack.push(action)
        snap()
        stack.undo()
        snap()
        stack.redo()
        snap()
    stack.set_clean()
    states.append(stack.is_clean)
    stack.undo()
    states.append(stack.is_clean)
    snap()
    return states


def test_undo_redo_of_each_action_matches_jax():
    got, want = _edits(mk_t, undo_t), _edits(mk_j, undo_j)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert repr(g) == repr(w)


def test_move_action_offsets_a_port_trace_line():
    t = np.linspace(0.0, 1.0, 10)
    line = mk_t.TraceLine(t, np.full(10, 440.0))
    before, speed, center = line.offset, line.speed.copy(), line.speed_center[1]
    stack = undo_t.UndoStack([line])
    stack.push(undo_t.MoveAction([line], 0.0, 0.25))
    assert line.offset == pytest.approx(before + 0.25)
    np.testing.assert_allclose(line.speed, speed + 0.25)
    assert line.speed_center[1] == pytest.approx(center + 0.25)
    stack.undo()
    assert line.offset == pytest.approx(before)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_config_path_is_the_jax_packages():
    assert cfg_t.config_path() == cfg_j.config_path()


def test_config_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "config.json"
    monkeypatch.setattr(cfg_t, "config_path", lambda: str(path))
    assert cfg_t.load_config() == {}
    cfg = {"fft_size": 2048, "cmap": "izo", "nested": {"a": [1, 2.5]}}
    cfg_t.save_config(cfg)
    assert cfg_t.load_config() == cfg
    assert cfg_j.load_json(str(path)) == cfg  # the JAX package reads it
    assert path.read_text() == json.dumps(cfg, indent="\t", sort_keys=True)
    cfg_t.save_json(str(tmp_path / "missing" / "x.json"), cfg)  # logs, does not raise
