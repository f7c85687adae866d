"""Bounded environment/health checks: the ``doctor`` CLI subcommand
(counterpart of pyaudiorestoration_tpu/utils/doctor.py).

Deployments hit three recurring operational failures that are miserable to
diagnose from a hung pipeline: a wedged device runtime (CUDA init blocks
forever), a native codec library that silently fell back to the slow path,
and a kernel library that cannot be built (no ``nvcc``) or computes wrong
results.  ``doctor`` checks each with hard timeouts and reports one JSON
object, so orchestration can gate on it (the reference has no equivalent;
SURVEY.md §5 "failure detection").

The device probe runs in a SUBPROCESS with a timeout — a wedged runtime
hangs inside native init where in-process watchdogs (signals,
faulthandler) cannot fire.  It imports torch, runs a tiny op, then builds
and loads the kernel library and launches K1's grid entry once on a small
plan, against its plain version.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["run_doctor"]

_ROOT = Path(__file__).resolve().parents[2]  # the checkout: the child imports the port
K1_TOL = 3e-5  # K1 against its plain version, as chip_smoke holds it

_PROBE = "from pyaudiorestoration_tpu_torch.utils.doctor import _probe_main; _probe_main()"


def _probe_main():
    """The child's body: print one JSON line about the device named by
    ``_DOCTOR_DEVICE`` (default cuda); raise where it is unusable."""
    t0 = time.perf_counter()
    import torch

    dev = torch.device(os.environ.get("_DOCTOR_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA card")
    ones = torch.ones((128,), device=dev)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    val = float(torch.sum(ones * 2.0))
    t_op = time.perf_counter() - t0

    from ..kernels import sinc_banded as kb

    # a small plan: 4 rows of 256 outputs at speeds 0.995-1.005, sinc
    # quality 8 (the anchor drifts at most ~3 samples over a row)
    g = torch.Generator().manual_seed(0)
    max_n, nt, drift = 256, 8, 8
    sig = torch.randn(4 * max_n + 64, generator=g).to(dev)
    s_lo = (0.995 + 0.01 * torch.rand(4, generator=g)).to(dev)
    s_hi = (0.995 + 0.01 * torch.rand(4, generator=g)).to(dev)
    n = torch.full((4,), max_n, dtype=torch.int32, device=dev)
    base_frac = torch.full((4,), 0.25, device=dev)
    base_int = torch.arange(4, dtype=torch.int32, device=dev) * max_n + 16
    grids = kb.segment_grids(s_lo, s_hi, n, base_frac, max_n)
    t0 = time.perf_counter()
    before = kb.launches()[0]
    got = kb.sinc_banded(sig, base_int, *grids, nt, drift)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_k1 = time.perf_counter() - t0
    err = float((got - kb.sinc_banded_plain(sig, base_int, *grids, nt, drift)).abs().max())
    print(json.dumps({
        "platform": dev.type,
        "device_count": torch.cuda.device_count() if dev.type == "cuda" else 1,
        "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "init_s": round(t_init, 2),
        "tiny_op_s": round(t_op, 2),
        "tiny_op_ok": val == 256.0,
        "k1_build_launch_s": round(t_k1, 2),
        "k1_launches": kb.launches()[0] - before,
        "k1_max_abs_err": err,
        "k1_ok": err <= K1_TOL and (dev.type != "cuda" or kb.launches()[0] > before),
    }))


def _probe_devices(timeout_s: float, platform: str | None = None):
    """Run the device probe in a subprocess on the torch device
    ``platform`` ("cuda", the default, "cuda:N" or "cpu"); returns (status,
    info dict).  On a timeout the child's whole process group is killed (an
    ``nvcc`` it started too)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_ROOT)] + [p for p in (env.get("PYTHONPATH") or "").split(os.pathsep) if p])
    if platform:
        env["_DOCTOR_DEVICE"] = platform
    proc = subprocess.Popen([sys.executable, "-c", _PROBE], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return "timeout", {"timeout_s": timeout_s}
    if proc.returncode != 0:
        return "error", {"stderr": err.strip()[-400:]}
    try:
        return "ok", json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return "error", {"stdout": out.strip()[-400:]}


def run_doctor(device_timeout_s: float = 120.0, skip_device: bool = False,
               device="cuda"):
    """Collect the health report dict (printed as JSON by the CLI).
    ``device`` names what the probe checks: "cuda" (the card, default) or
    "cpu"."""
    report = {"healthy": True}

    # native codec
    t0 = time.perf_counter()
    try:
        from . import audio_io

        lib = audio_io._get_lib()
        report["native_codec"] = {
            "loaded": lib is not None,
            "load_s": round(time.perf_counter() - t0, 2),
        }
        if lib is None:
            report["healthy"] = False
            report["native_codec"]["hint"] = (
                "the native codec is missing and its build failed; check that a "
                "C++ compiler is available (it builds csrc/audioio.cpp)")
    except Exception as e:  # noqa: BLE001 - health check must not raise
        report["native_codec"] = {"loaded": False, "error": repr(e)}
        report["healthy"] = False

    # the kernel library's build directory (reported; the probe gates)
    try:
        from ..kernels import sinc_banded as kb

        build_dir = kb._BUILD_DIR
        n_entries = sum(1 for _ in os.scandir(build_dir)) if build_dir.is_dir() else 0
        nvcc = kb._nvcc()
        report["kernels"] = {"dir": str(build_dir), "entries": n_entries,
                             "warm": n_entries > 0,
                             "nvcc": nvcc if os.path.isfile(nvcc) else None}
    except Exception as e:  # noqa: BLE001
        report["kernels"] = {"error": repr(e)}

    # device runtime (bounded; a wedged runtime must not hang the doctor)
    if not skip_device:
        status, info = _probe_devices(device_timeout_s, platform=str(device))
        if status == "ok" and not (info.get("tiny_op_ok", False)
                                   and info.get("k1_ok", False)):
            # initialized but computing WRONG results — worse than down
            status = "wrong_result"
        report["device"] = {"status": status, **info}
        if status != "ok":
            report["healthy"] = False
            if status == "timeout":
                report["device"]["hint"] = (
                    "device runtime did not answer within the timeout — "
                    "runtime wedged or another process holds the device; "
                    "this process would hang in CUDA init")
            if str(device).startswith("cuda"):
                # a CPU probe tells operators whether torch itself works;
                # it never makes the report healthy
                cpu_status, cpu_info = _probe_devices(60.0, platform="cpu")
                report["device"]["cpu_fallback"] = {"status": cpu_status, **cpu_info}

    return report
