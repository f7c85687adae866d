"""The PyTorch port stands alone: no module of ``pyaudiorestoration_tpu_torch``,
nor ``chip_smoke.py`` or ``profile_stages.py``, imports JAX or anything of the
JAX package, and ``respeed --fast``, ``tapesync``, ``heal`` and
``dropouts-batch`` run with ``--device cpu`` and both blocked."""

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


_RUN_BLOCKED = """
import importlib.abc, json, sys
BLOCKED = ("jax", "jaxlib", "pyaudiorestoration_tpu")

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
rc = cli.main(sys.argv[1:])
loaded = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib") or m.startswith("pyaudiorestoration_tpu.")))
print(json.dumps({"rc": rc, "loaded": loaded}))
"""


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


def _run_blocked(argv, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    r = subprocess.run([sys.executable, "-c", _RUN_BLOCKED, *argv, "--device", "cpu"],
                       cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "loaded": []}
    return json.loads(lines[-2])


@pytest.mark.parametrize("cmd", ["tapesync", "heal", "dropouts-batch"])
def test_spectral_tools_run_with_the_jax_package_blocked(tmp_path, cmd):
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
    assert _run_blocked(argv, ROOT)["outputs"] == want
    for path in want:
        osr, y = wavfile.read(path)
        assert osr == sr and np.all(np.isfinite(y)) and abs(len(y) - len(x)) < 0.02 * len(x)
