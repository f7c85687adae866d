"""The PyTorch port stands alone: no module of ``pyaudiorestoration_tpu_torch``,
nor ``chip_smoke.py`` or ``profile_stages.py``, imports JAX or anything of the
JAX package, and ``respeed --fast --device cpu`` runs with both blocked."""

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
import json, sys
for name in ("jax", "jaxlib", "pyaudiorestoration_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
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
