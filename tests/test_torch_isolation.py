"""The PyTorch port stands alone: no module of ``pyaudiorestoration_tpu_torch``,
nor ``chip_smoke.py`` or ``profile_stages.py``, imports JAX or anything of the
JAX package, and ``respeed --fast``, ``tapesync``, ``heal``,
``dropouts-batch``, ``respeed-batch --tier fixed``, the nine spectral and
analysis tools, ``renoise --preview`` and the user-facing surface
(``view``, ``listen``, ``measure``, ``doctor --no-device``, ``tapesync
--compare x.html``) run with ``--device cpu`` and both blocked, and
``bench`` exits 3 (no card here) without loading either.  The
surface runs with matplotlib blocked as well, where ``tapesync --compare
x.png`` raises matplotlib's ImportError.  The fixed tier's file entry
over two ranks runs with both blocked in the caller's process and in the
two ranks it spawns, none of which loads them."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy.io import wavfile

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in
                    (ROOT / "pyaudiorestoration_tpu_torch").rglob("*.py"))
SCRIPTS = ["chip_smoke.py", "profile_stages.py"]
FORBIDDEN = ("jax", "jaxlib", "pyaudiorestoration_tpu")


def _imports(tree):
    """Absolute module names imported anywhere in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_files_found():
    assert "pyaudiorestoration_tpu_torch/kernels/sinc_banded.py" in PORT_FILES
    assert "pyaudiorestoration_tpu_torch/utils/audio_io.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES + SCRIPTS)
def test_imports_no_jax_nor_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = sorted({m for m in _imports(tree) if _forbidden(m)})
    assert not bad, f"{path} imports {bad}"


_BLOCK = """
import importlib.abc, json, sys
BLOCKED = BLOCKED_NAMES

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")

# any import of them now raises ImportError; they are absent from
# sys.modules, as where they are not installed (scipy probes sys.modules)
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.meta_path.insert(0, Blocker())
from pyaudiorestoration_tpu_torch import cli
"""
_LOADED = """
loaded = sorted(m for m, mod in sys.modules.items()
                if mod is not None and m.split(".")[0] in BLOCKED)
"""
JAX_NAMES = ("jax", "jaxlib", "pyaudiorestoration_tpu")
_RUN_BLOCKED = (_BLOCK.replace("BLOCKED_NAMES", repr(JAX_NAMES))
                + "rc = cli.main(sys.argv[1:])\n" + _LOADED
                + 'print(json.dumps({"rc": rc, "loaded": loaded}))\n')
# several CLI commands in one process (one interpreter start): each its rc,
# its last stdout line and its stderr (a traceback where it raised); the
# blocked names replace BLOCKED_NAMES
_RUN_MANY_BLOCKED = _BLOCK + """
import contextlib, io, traceback
runs = []
for argv in json.loads(sys.argv[1]):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except Exception:
            rc = None
            traceback.print_exc()
    lines = out.getvalue().strip().splitlines()
    runs.append({"rc": rc, "last": lines[-1] if lines else "", "err": err.getvalue()})
""" + _LOADED + 'print(json.dumps({"runs": runs, "loaded": loaded}))\n'


def test_respeed_fast_runs_with_the_jax_package_blocked(tmp_path):
    sr, seconds = 8000, 2.0
    t = np.arange(int(sr * seconds)) / sr
    speed = 1.0 + 0.02 * np.sin(2 * np.pi * 1.1 * t)
    sig = (0.5 * np.sin(2 * np.pi * 1000 * np.cumsum(speed) / sr)).astype(np.float32)
    src = tmp_path / "tone.wav"
    wavfile.write(src, sr, np.stack([sig, 0.7 * sig], -1))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run(
        [sys.executable, "-c", _RUN_BLOCKED, "respeed", str(src), "--fast", "--device",
         "cpu", "--f0", "1000", "--fft-size", "512", "--zeropad", "2",
         "--sinc-quality", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    status = json.loads(lines[-1])
    assert status == {"rc": 0, "loaded": []}
    out = tmp_path / "tone_res.wav"
    assert json.loads(lines[-2])["outputs"] == [str(out)]
    osr, y = wavfile.read(out)
    assert osr == sr and y.shape[1] == 2 and np.all(np.isfinite(y))
    assert abs(len(y) - len(sig)) < 0.02 * len(sig)


def _spectral_inputs(tmp_path, cmd):
    """A 4 s 8 kHz random walk with a dropout (and, for tapesync, a second
    take 400 samples ahead); the command line and the outputs it writes."""
    sr = 8000
    rng = np.random.default_rng(5)
    base = np.cumsum(rng.standard_normal(4 * sr + 400)).astype(np.float32)
    base = 0.5 * (base - base.mean()) / np.abs(base - base.mean()).max()
    x = np.stack([base[:4 * sr], 0.7 * base[:4 * sr]], -1)
    x[sr:sr + 400] *= 0.05
    src = tmp_path / "a.wav"
    wavfile.write(src, sr, x)
    if cmd == "tapesync":
        other = tmp_path / "b.wav"
        wavfile.write(other, sr, np.stack([base[400:], base[400:]], -1))
        argv = [cmd, str(src), str(other), "--windows", "4", "--window-s", "0.5",
                "--sinc-quality", "8"]
        want = [str(tmp_path / "b_res.wav")]
    elif cmd == "heal":
        argv = [cmd, str(src), "--detect", "0.5", "2.0", "200", "3000"]
        want = [str(tmp_path / "a_drops.wav")]
    else:
        argv = [cmd, str(src), "--mode", "MaxMono"]
        want = [str(tmp_path / "amax.wav"), str(tmp_path / "amin.wav")]
    return argv, want, sr, len(x)


SPECTRAL = ["tapesync", "heal", "dropouts-batch"]


def _fixed_tier_inputs(tmp_path):
    """Two 4 s 8 kHz tones with 2 % wow; the fixed tier's argv (no device)
    and the outputs it writes."""
    sr, paths = 8000, []
    for i in range(2):
        t = np.arange(4 * sr - 500 * i) / sr
        speed = 1.0 + 0.02 * np.sin(2 * np.pi * (2.0 + 0.5 * i) * t)
        paths.append(str(tmp_path / f"w{i}.wav"))
        wavfile.write(paths[-1], sr, np.sin(2 * np.pi * 1000 * np.cumsum(speed) / sr)
                      .astype(np.float32))
    argv = ["respeed-batch", *paths, "--tier", "fixed", "--f0", "1000", "--fft-size",
            "512", "--step", "128"]
    return argv, [p[:-4] + "_res.wav" for p in paths]


def _tool_inputs(tmp_path, sr=8000, seconds=4.0):
    """Stereo noise with a hum and a tone (4 s at 8 kHz), its compressed
    copy, a 44 rpm record's tone and a two-sample .pan project."""
    from pyaudiorestoration_tpu_torch.models import markers as mk
    from pyaudiorestoration_tpu_torch.utils import project

    n = int(seconds * sr)
    t = np.arange(n) / sr
    rng = np.random.default_rng(7)
    hum = sum(0.05 * np.sin(2 * np.pi * f * 1.01 * t) for f in (50, 100, 150))
    sig = 0.1 * rng.standard_normal(n) + hum + 0.3 * np.sin(2 * np.pi * 700 * t)
    env = 0.2 + 0.6 * (np.sin(2 * np.pi * 0.5 * t) > 0)
    paths = {}
    for name, x in (("a", np.stack([sig, 0.8 * sig], -1)),
                    ("b", np.stack([np.roll(sig, 9), 0.8 * np.roll(sig, 9)], -1)),
                    ("c", np.stack([sig * env, sig * env], -1))):
        paths[name] = str(tmp_path / f"{name}.wav")
        wavfile.write(paths[name], sr, x.astype(np.float32))
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * 44 / 60 * np.arange(2 * n) / sr)
    paths["rec"] = str(tmp_path / "rec.wav")
    wavfile.write(paths["rec"], sr,
                  np.sin(2 * np.pi * 700 * np.cumsum(speed) / sr).astype(np.float32))
    paths["pan"] = str(tmp_path / "a.pan")
    project.Project(".pan", {"fft_size": 512, "fft_overlap": 4}, {"markers": [
        mk.PanSample((0.5, 100.0), (1.0, 3000.0), 0.7),
        mk.PanSample((2.5, 100.0), (3.0, 3000.0), 1.2)]}).save(paths["pan"])
    return paths


TOOLS = {
    "difeq": (["difeq", "{b}", "{a}", "-o", "{tmp}/eq.txt"],
              ["eq.txt", "eq_L.txt", "eq_R.txt"]),
    "expand": (["expand", "{a}", "--band-lower", "2000", "--band-upper", "3500"],
               ["a_decompressed.wav"]),
    "hpss": (["hpss", "{a}", "--fft-size", "512", "--kernel", "9"], ["a_H.wav", "a_P.wav"]),
    "renoise": (["renoise", "{a}", "--selection", "0.5", "1.5"], ["a fft=1024.wav"]),
    "humspeed": (["humspeed", "{a}", "--harmonies", "2"], None),
    "pan": (["pan", "{a}", "--project", "{pan}"], ["a_out.wav"]),
    "decompress": (["decompress", "{a}", "{c}"], ["a_decompressed.wav"]),
    "group-delay": (["group-delay", "{a}", "{b}", "--upper", "1000"], []),
    "cyclic-wow": (["cyclic-wow", "{rec}", "--fft-size", "4096"], []),
    "renoise --preview": (["renoise", "{a}", "--selection", "0.5", "1.5", "--preview",
                           "{tmp}/p.png"], None),
}


# the user-facing surface: argv, then the outputs (None: checked below)
SURFACE = {
    "view": (["view", "{a}", "--trail", "0.5", "700", "3.5", "700"], ["a.html"]),
    "listen": (["listen", "{a}", "{b}", "-o", "{tmp}/aud.html"], ["aud.html"]),
    "measure": (["measure", "{a}", "{b}"], None),
    "doctor": (["doctor", "--no-device"], None),
    "tapesync --compare": (["tapesync", "{a}", "{b}", "--windows", "4", "--window-s", "0.5",
                            "--sinc-quality", "8", "--compare", "{tmp}/c.html"], None),
}


def _run_many(argvs, blocked):
    """``_RUN_MANY_BLOCKED`` over ``argvs`` with ``blocked`` blocked: the
    runs, after checking that none of them was loaded."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    script = _RUN_MANY_BLOCKED.replace("BLOCKED_NAMES", repr(blocked))
    r = subprocess.run([sys.executable, "-c", script, json.dumps(argvs)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    status = json.loads(r.stdout.strip().splitlines()[-1])
    assert status["loaded"] == []
    return status["runs"]


def _surface_argvs(tmp_path_factory, dirs, prefix=""):
    argvs = []
    for cmd, (argv, _) in SURFACE.items():
        d = dirs[prefix + cmd] = tmp_path_factory.mktemp(cmd.replace(" --", "_"))
        paths = _tool_inputs(d)
        argvs.append([a.format(tmp=d, **paths) for a in argv] + ["--device", "cpu"])
    return argvs


@pytest.fixture(scope="module")
def blocked_runs(tmp_path_factory):
    """Every subcommand below, each on its own inputs in its own directory,
    through the CLI with ``--device cpu`` in one process with JAX and the
    JAX package blocked: {name: (directory, run record)}."""
    dirs, argvs = {}, []
    for cmd in SPECTRAL:
        d = dirs[cmd] = tmp_path_factory.mktemp(cmd)
        argvs.append(_spectral_inputs(d, cmd)[0] + ["--device", "cpu"])
    for cmd, (argv, _) in TOOLS.items():
        d = dirs[cmd] = tmp_path_factory.mktemp(cmd.replace(" --", "_"))
        paths = _tool_inputs(d)
        argvs.append([a.format(tmp=d, **paths) for a in argv] + ["--device", "cpu"])
    argvs += _surface_argvs(tmp_path_factory, dirs)
    d = dirs["respeed-batch --tier fixed"] = tmp_path_factory.mktemp("fixed_tier")
    argvs.append(_fixed_tier_inputs(d)[0] + ["--device", "cpu"])
    dirs["bench"] = tmp_path_factory.mktemp("bench")
    argvs.append(["bench"])
    runs = _run_many(argvs, JAX_NAMES)
    return {cmd: (dirs[cmd], run) for cmd, run in zip(dirs, runs)}


@pytest.fixture(scope="module")
def no_matplotlib_runs(tmp_path_factory):
    """The surface again, with matplotlib blocked as well, and ``tapesync
    --compare x.png``, which needs it."""
    dirs = {}
    argvs = _surface_argvs(tmp_path_factory, dirs)
    d = dirs["tapesync --compare png"] = tmp_path_factory.mktemp("compare_png")
    argvs.append([a.format(tmp=d, **_tool_inputs(d)) for a in SURFACE[
        "tapesync --compare"][0]][:-1] + [str(d / "c.png"), "--device", "cpu"])
    runs = _run_many(argvs, JAX_NAMES + ("matplotlib",))
    return {cmd: (dirs[cmd], run) for cmd, run in zip(dirs, runs)}


def _outputs(run):
    assert run["rc"] == 0, run["err"][-3000:]
    return json.loads(run["last"])


@pytest.mark.parametrize("cmd", SPECTRAL)
def test_spectral_tools_run_with_the_jax_package_blocked(blocked_runs, cmd):
    tmp_path, run = blocked_runs[cmd]
    _, want, sr, n = _spectral_inputs(tmp_path, cmd)
    assert _outputs(run)["outputs"] == want
    for path in want:
        osr, y = wavfile.read(path)
        assert osr == sr and np.all(np.isfinite(y)) and abs(len(y) - n) < 0.02 * n


@pytest.mark.parametrize("cmd", [c for c in TOOLS if c != "renoise --preview"])
def test_analysis_tools_run_with_the_jax_package_blocked(blocked_runs, cmd):
    tmp_path, run = blocked_runs[cmd]
    out = _outputs(run)
    want = TOOLS[cmd][1]
    if cmd == "humspeed":
        ratio = out["matches"][-1]["ratio"]
        assert ratio == pytest.approx(1 / 1.01, abs=2e-3)
        want = ["a_resampled_%.3f.wav" % ((ratio - 1) * 100)]
    assert out.get("outputs", []) == [str(tmp_path / w) for w in want]
    for path in out.get("outputs", []):
        if path.endswith(".wav"):
            y = wavfile.read(path)[1]
            assert np.all(np.isfinite(y)) and abs(len(y) - 32000) < 0.02 * 32000
        else:
            assert open(path).read().startswith("FilterCurve:")
    if cmd == "group-delay":
        lags = [b["lag_samples"] for b in out["bands"]]
        assert len(lags) >= 3 and abs(np.median(lags) + 9) < 1
    elif cmd == "cyclic-wow":
        assert out["actual_rpm"] == pytest.approx(44.0, rel=0.02)


def test_renoise_preview_exits_not_ported_with_the_jax_package_blocked(blocked_runs):
    """``renoise --preview`` writes its figure (matplotlib is present here)."""
    pytest.importorskip("matplotlib")
    tmp_path, run = blocked_runs["renoise --preview"]
    assert _outputs(run) == {"preview": str(tmp_path / "p.png")}
    with open(tmp_path / "p.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def _check_surface(runs, cmd):
    tmp_path, run = runs[cmd]
    out = _outputs(run)
    want = SURFACE[cmd][1]
    if want is not None:
        assert out == {"outputs": [str(tmp_path / w) for w in want]}
        page = (tmp_path / want[0]).read_text()
        assert page.lower().startswith("<!doctype html>") and "base64," in page
        if cmd == "view":
            assert '"color": "#ff5050"' in page  # the traced curve
    elif cmd == "measure":
        assert set(out) == {"flutter", "snr_db", "spectral_distance_db"}
        assert out["spectral_distance_db"] >= 0
    elif cmd == "doctor":
        assert out["healthy"] is True and "device" not in out
    else:
        assert out["compare"] == str(tmp_path / "c.html")
        assert (tmp_path / "c.html").read_text().startswith("<!DOCTYPE html>")


@pytest.mark.parametrize("cmd", list(SURFACE))
def test_surface_runs_with_the_jax_package_blocked(blocked_runs, cmd):
    _check_surface(blocked_runs, cmd)


@pytest.mark.parametrize("cmd", list(SURFACE))
def test_surface_runs_with_matplotlib_blocked(no_matplotlib_runs, cmd):
    _check_surface(no_matplotlib_runs, cmd)


def test_png_compare_raises_matplotlibs_import_error(no_matplotlib_runs):
    tmp_path, run = no_matplotlib_runs["tapesync --compare png"]
    assert run["rc"] is None
    assert "ImportError: matplotlib is blocked" in run["err"]
    assert not (tmp_path / "c.png").exists()


def _check_fixed_tier(outputs, want):
    assert outputs == want
    for i, path in enumerate(want):
        sr, y = wavfile.read(path)
        assert sr == 8000 and len(y) == 4 * sr - 500 * i and np.all(np.isfinite(y))


def test_fixed_tier_runs_with_the_jax_package_blocked(blocked_runs):
    tmp_path, run = blocked_runs["respeed-batch --tier fixed"]
    _check_fixed_tier(_outputs(run)["outputs"], _fixed_tier_inputs(tmp_path)[1])


def test_bench_exits_3_with_the_jax_package_blocked(blocked_runs):
    """Its device probe finds no card: exit 3, one stderr line, no JSON
    line; neither JAX nor the JAX package was loaded (``_run_many``)."""
    _, run = blocked_runs["bench"]
    assert run["rc"] == 3 and run["last"] == ""
    lines = run["err"].strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("bench: device runtime unavailable")


# installed in every interpreter of the run, the spawned ranks included:
# blocks the names and, at exit, writes the ones loaded beside itself
_SITE = _BLOCK.split("from pyaudiorestoration_tpu_torch import cli")[0] + """
import atexit, os

def _report():
    loaded = sorted(m for m, mod in sys.modules.items()
                    if mod is not None and m.split(".")[0] in BLOCKED)
    name = f"loaded_{os.getpid()}.json"
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), name), "w") as f:
        json.dump(loaded, f)

atexit.register(_report)
"""


_FIXED_TWO_RANKS = """
import json, sys
from pyaudiorestoration_tpu_torch.parallel import batch
print(json.dumps(batch.restore_batch_files(sys.argv[1:], 1000.0, n_fft=512, step=128,
                                           device="cpu", n_ranks=2)))
"""


def test_fixed_tier_ranks_run_with_the_jax_package_blocked(tmp_path):
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE.replace("BLOCKED_NAMES", repr(JAX_NAMES)))
    argv, want = _fixed_tier_inputs(tmp_path)
    env = {**os.environ, "PYTHONPATH": f"{site}{os.pathsep}{ROOT}"}
    r = subprocess.run([sys.executable, "-c", _FIXED_TWO_RANKS, *argv[1:3]],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    _check_fixed_tier(json.loads(r.stdout.strip().splitlines()[-1]), want)
    reports = sorted(site.glob("loaded_*.json"))
    # the caller's process, its two ranks and multiprocessing's resource tracker
    assert len(reports) == 4
    assert all(json.loads(p.read_text()) == [] for p in reports)
