"""The port's ``doctor`` (tests/test_cli.py:138-175 for the JAX package's):
the ``--no-device`` JSON contract, the probe in its subprocess on the CPU,
a probe that hangs reported as ``timeout`` within its limit, a wrong
tiny-op or K1 result gating health, and a card probe that fails here
(there is no card) making the report unhealthy (exit 2) beside a CPU probe
that never makes it healthy."""

import json
import time

import pytest
import torch

from pyaudiorestoration_tpu_torch import cli
from pyaudiorestoration_tpu_torch.utils import doctor


def test_cli_doctor_no_device(capsys):
    rc = cli.main(["doctor", "--no-device"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rep["healthy"] is True
    assert rep["native_codec"]["loaded"] is True
    kernels = rep["kernels"]
    assert set(kernels) == {"dir", "entries", "warm", "nvcc"}
    assert kernels["dir"].endswith("build/torch_kernels")
    assert kernels["warm"] == (kernels["entries"] > 0)
    assert "device" not in rep


def test_doctor_cpu_probe_subprocess():
    """The bounded subprocess probe on the CPU: torch's tiny op, and K1's
    wrapper (its plain version on a CPU tensor) on the small plan."""
    status, info = doctor._probe_devices(120.0, platform="cpu")
    assert status == "ok", info
    assert info["platform"] == "cpu" and info["device_count"] == 1
    assert info["tiny_op_ok"] is True and info["k1_ok"] is True
    assert info["k1_launches"] == 0 and info["k1_max_abs_err"] == 0.0


def test_doctor_probe_that_hangs_times_out(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE", "import time; time.sleep(120)")
    t0 = time.perf_counter()
    status, info = doctor._probe_devices(2.0)
    assert status == "timeout" and info == {"timeout_s": 2.0}
    assert time.perf_counter() - t0 < 20.0


@pytest.mark.parametrize("bad", ["tiny_op_ok", "k1_ok"])
def test_doctor_gates_on_wrong_result(monkeypatch, bad):
    """A device that initializes but computes wrong results is unhealthy
    ('wrong_result'), with the CPU probe reported beside it."""
    calls = []

    def fake_probe(timeout_s, platform=None):
        calls.append(platform)
        info = {"tiny_op_ok": True, "k1_ok": True, "device_count": 1, "platform": platform}
        if platform == "cuda":
            info[bad] = False
        return "ok", info

    monkeypatch.setattr(doctor, "_probe_devices", fake_probe)
    rep = doctor.run_doctor(device_timeout_s=5.0)
    assert rep["device"]["status"] == "wrong_result"
    assert rep["healthy"] is False
    assert rep["device"]["cpu_fallback"]["status"] == "ok"
    assert calls == ["cuda", "cpu"]


def test_doctor_healthy_probe_and_cpu_device(monkeypatch):
    def fake_probe(timeout_s, platform=None):
        return "ok", {"tiny_op_ok": True, "k1_ok": True, "platform": platform}

    monkeypatch.setattr(doctor, "_probe_devices", fake_probe)
    rep = doctor.run_doctor(device_timeout_s=5.0)
    assert rep["healthy"] is True and rep["device"]["status"] == "ok"
    assert "cpu_fallback" not in rep["device"]
    rep = doctor.run_doctor(device_timeout_s=5.0, device="cpu")
    assert rep["healthy"] is True and rep["device"]["platform"] == "cpu"


def test_cli_doctor_without_a_card_is_unhealthy(capsys):
    """Here torch sees no card: the card probe errors, the report is
    unhealthy and ``doctor`` exits 2, whatever the CPU probe says."""
    if torch.cuda.is_available():
        pytest.skip("a card is present, so its probe does not fail")
    rc = cli.main(["doctor", "--device-timeout", "120"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 2 and rep["healthy"] is False
    assert rep["device"]["status"] == "error"
    assert "no CUDA card" in rep["device"]["stderr"]
    assert rep["device"]["cpu_fallback"]["status"] == "ok"
