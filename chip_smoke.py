"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds kernel K1 (the banded windowed-sinc resampler,
pyaudiorestoration_tpu_torch/csrc/sinc_banded.cu) from the checkout, holds
it against its plain PyTorch version at the main path's shape, then drives
the port's ``respeed --fast`` CLI on a synthesized 30 s, 192 kHz stereo
wow/flutter take (fft 4096, overlap 8, zeropad 2, sinc quality 50).

Phases print on their own lines; the line before the last is a JSON object
with each kernel's launches on the main path, its error against the plain
version and both times; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises and exits non-zero with no result line.  Imports no JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from scipy.io import wavfile

SR = 192_000
SECONDS = 30.0
F0 = 3150.0  # the wow/flutter test tone of IEC 60386
FFT, OVERLAP, ZEROPAD, QUALITY = 4096, 8, 2, 50
TOL = 3e-5  # kernel vs plain version, as the JAX kernel vs its XLA tier


def tone_stability(sig, sr, smooth_periods=32):
    """Relative std of a tone's instantaneous frequency from sub-sample zero
    crossings averaged over ``smooth_periods`` periods (tests/test_respeeder.py)."""
    idx = np.where(np.bitwise_xor(sig[1:] > 0, sig[:-1] > 0))[0]
    crossings = idx + sig[idx] / (sig[idx] - sig[idx + 1])
    k = smooth_periods
    freqs = 2 * sr / ((crossings[2 * k:] - crossings[:-2 * k]) / k)
    core = freqs[len(freqs) // 10: -len(freqs) // 10]
    return float(np.std(core) / np.mean(core))


def wow_take(sr, seconds, seed=0):
    """Stereo pilot tone with 0.55 Hz wow (0.8 %) and 6.3 Hz flutter (0.15 %):
    drift bound ~10 samples at max_n ~563, inside the 16 bucket."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    speed = (1.0 + 0.008 * np.sin(2 * np.pi * 0.55 * t)
             + 0.0015 * np.sin(2 * np.pi * 6.3 * t + 1.0))
    phase = 2 * np.pi * F0 * np.cumsum(speed) / sr
    rng = np.random.default_rng(seed)
    mono = (0.5 * np.sin(phase) + 1e-3 * rng.standard_normal(n)).astype(np.float32)
    return np.stack([mono, mono * 0.8], -1)


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` over ``reps`` runs, timed with CUDA
    events after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    from pyaudiorestoration_tpu_torch import cli
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
    from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch
    from pyaudiorestoration_tpu_torch.utils.device import resolve_device

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = resolve_device("cuda")

    # 2. build K1 from the checkout
    t0 = time.perf_counter()
    so = kb.build()
    build_s = time.perf_counter() - t0
    print(f"build: {so.name} in {build_s:.2f} s")

    # 3. K1 against its plain version at the main path's shape
    take = wow_take(SR, SECONDS)
    hop = FFT // OVERLAP
    n = take.shape[0]
    f0 = rt._probe_f0(take[:, 0], SR)
    NL, NU = rt._band_limits(f0, 1.0, FFT, ZEROPAD, SR)
    n_frames = n // hop + 1
    sig = torch.as_tensor(np.ascontiguousarray(take.T), device=dev)
    speeds = rt.track_speed_device(
        sig[0], torch.full((n_frames,), NL, dtype=torch.int32, device=dev),
        torch.full((n_frames,), NU, dtype=torch.int32, device=dev),
        FFT, hop, ZEROPAD, band=(NL - 1, NU + 1))
    plan = rt.plan_positions_fast(speeds.cpu().numpy(), hop, n)
    p = plan_to_torch(plan, dev)
    drift = rt._drift_bucket(p["drift"])
    max_n = p["max_n"]
    if drift > 64:
        raise RuntimeError(f"take's drift bucket {drift} is over 64")
    C = sig.shape[0]
    # the flattening and chunks run_banded_sinc feeds K1 on the main path
    flat = rt._flatten_takes(
        sig, speeds.expand(C, -1), p["n"].expand(C, -1), p["base_int"].expand(C, -1),
        p["base_frac"].expand(C, -1), max_n, QUALITY, drift)
    chunks = list(rt.segment_chunks(flat, max_n))

    def run(fn):
        return [fn(flat[0], *c, QUALITY, drift) for c in chunks]

    got = run(kb.sinc_banded)
    ref = run(kb.sinc_banded_plain)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    print(f"K1 vs plain: segments {flat[3].shape[0]} x max_n {max_n}, nt {QUALITY}, "
          f"drift {drift}, chunks {len(chunks)}, max|d| {err:.3e} (tol {TOL})")
    if not err <= TOL:
        raise RuntimeError(f"K1 disagrees with its plain version: {err}")
    kernel_ms = cuda_ms(lambda: run(kb.sinc_banded), 20)
    plain_ms = cuda_ms(lambda: run(kb.sinc_banded_plain), 5)
    print(f"K1 whole take: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"({plain_ms / kernel_ms:.1f}x)")

    # 4. the main path end to end through the CLI
    argv = ["--fast", "--device", "cuda", "--fft-size", str(FFT), "--fft-overlap",
            str(OVERLAP), "--zeropad", str(ZEROPAD), "--sinc-quality", str(QUALITY)]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "take.wav")
        wavfile.write(src, SR, take)
        kb.sinc_banded.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["respeed", src, *argv])
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = kb.sinc_banded.launches
        if rc != 0 or launches < 1:
            raise RuntimeError(f"respeed --fast: rc {rc}, K1 launches {launches}")
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            if cli.main(["respeed", src, *argv]) != 0:
                raise RuntimeError("warm respeed --fast failed")
            warm.append(time.perf_counter() - t0)
        osr, out = wavfile.read(os.path.join(tmp, "take_res.wav"))
    warm_s = statistics.median(warm)
    if osr != SR or out.shape[1:] != (2,) or not np.all(np.isfinite(out)):
        raise RuntimeError(f"bad output: sr {osr}, shape {out.shape}")
    if abs(len(out) - n) > 0.01 * n:
        raise RuntimeError(f"output length {len(out)} vs input {n}")
    before = tone_stability(take[:, 0].astype(np.float64), SR)
    after = tone_stability(out[:, 0].astype(np.float64), SR)
    print(f"respeed --fast: {SECONDS:.0f} s take, K1 launches {launches}, "
          f"cold {cold_s:.3f} s (+ build {build_s:.2f} s), warm {warm_s:.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in warm)}), "
          f"{SECONDS / warm_s:.1f}x realtime; flutter {before:.2e} -> {after:.2e}")
    if not after < 0.2 * before:
        raise RuntimeError("flutter did not drop below 0.2x the input's")

    # 5. the card's restore against the port's CPU path on a small take
    small = wow_take(22050, 2.5, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for d in ("cuda", "cpu"):
            src = os.path.join(tmp, f"{d}.wav")
            wavfile.write(src, 22050, small)
            outs.append(wavfile.read(rt.restore_file_fast(
                src, fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=30,
                device=d))[1])
    a, b = outs
    m = min(len(a), len(b)) - 100
    d = np.abs(a[100:m] - b[100:m])
    print(f"cuda vs cpu (2.5 s, 22.05 kHz): lengths {len(a)} / {len(b)}, "
          f"median |d| {np.median(d):.2e}, share > 1e-2 {(d > 1e-2).mean():.4f}")
    if abs(len(a) - len(b)) > 2 or not np.median(d) < 1e-4 or not (d > 1e-2).mean() < 0.01:
        raise RuntimeError("the card's restore disagrees with the CPU path")

    print(json.dumps({"kernels": [{
        "name": "sinc_banded", "route": "cuda",
        "source": "pyaudiorestoration_tpu_torch/csrc/sinc_banded.cu",
        "replaces": "pyaudiorestoration_tpu/kernels/sinc_pallas.py:253",
        "launches": launches, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
