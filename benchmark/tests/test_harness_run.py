"""``benchmark/run.py`` as the driver runs it: no result without a card or
without the program, and on a card one result line with every key."""

import json
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT


def run_py(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tape192.take30",
                           "--seed", str(2 ** 31 + 7), "--seconds", "1", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    r = run_py(ROOT, "--trace", "0")
    assert r.returncode == 2 and r.stdout == ""
    assert "CUDA card" in r.stderr


def test_no_result_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run_py(tmp_path, "--trace", "0")
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_result_line_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = run_py(ROOT, "--trace", trace, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks" and result["metrics"]
    assert r.stderr.strip().splitlines()[-1].startswith("check ")
