"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds kernels K1 and K2 (the banded windowed-sinc resampler's two entries,
pyaudiorestoration_tpu_torch/csrc/sinc_banded.cu) from the checkout and, on
a synthesized 30 s, 192 kHz stereo wow/flutter take (fft 4096, overlap 8,
zeropad 2, sinc quality 50):

  1-2  the card, the build
  3    K1 against its plain PyTorch version at ``respeed --fast``'s shape
  4    the ``respeed --fast`` CLI, file to file
  5    that restore on the card against the port's CPU path, small take
  6    K2 against its plain version at the fused plan's shape
  7    ``restore_fused_device`` on the stereo take, K1 then K2 (bench.py:130)
  8    ``restore_fused_takes`` on 8 takes (bench.py:152), then a mixed-length
       batch, each row bit-equal to its solo run
  9    the ``respeed-batch`` CLI on three 10 s takes; the card against the
       CPU path on a small batch

Phases print on their own lines; the line before the last is a JSON object
with each kernel's launches on the main paths, its error against the plain
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
MAX_N, DRIFT = int(FFT // OVERLAP * 1.1), 16  # the fused entries' (bench.py:95, 132)


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


def wall_s(fn, reps):
    """Median host seconds of ``fn`` over ``reps`` runs, each ending in a
    synchronize; returns (median, runs)."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs), runs


def compare_compacted(a, b, what):
    """tests/test_restore_fused.py:88-96: median |d| < 1e-4 and under 1 % of
    samples over 1e-2 (dither boundaries may fall a sample apart)."""
    m = min(len(a), len(b)) - 100
    d = np.abs(a[100:m] - b[100:m])
    print(f"{what}: lengths {len(a)} / {len(b)}, median |d| {np.median(d):.2e}, "
          f"share > 1e-2 {(d > 1e-2).mean():.4f}")
    if abs(len(a) - len(b)) > 2 or not np.median(d) < 1e-4 or not (d > 1e-2).mean() < 0.01:
        raise RuntimeError(f"{what}: outputs disagree")


def reset_launches(kb):
    kb.sinc_banded.launches = 0
    kb.sinc_banded_gathered.launches = 0


def check_k2(sig, plan):
    """Phase 6: K2 against its plain version on the fused plan's own chunks
    (the gathered tier's ``segment_chunks`` and window buffers)."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    speeds, n, bi, bf = plan
    U = QUALITY + DRIFT
    inputs = []
    for ch in sig:  # the gathered tier runs channel by channel
        flat = (ch, speeds[:-1], speeds[1:], n, bi, bf)
        inputs += [(kb.gather_windows(ch, b, MAX_N + 2 * U, U), bs, rel, in_seg)
                   for b, bs, rel, in_seg in rt.segment_chunks(flat, MAX_N)]

    def kernel():
        return [kb.sinc_banded_gathered(*a, QUALITY, DRIFT) for a in inputs]

    def plain():
        return [kb.sinc_shift_mac(*a, MAX_N, QUALITY, DRIFT) for a in inputs]

    err = max(float((g - r).abs().max()) for g, r in zip(kernel(), plain()))
    rows = sum(a[0].shape[0] for a in inputs)
    print(f"K2 vs plain: segments {rows} x max_n {MAX_N}, nt {QUALITY}, drift {DRIFT}, "
          f"chunks {len(inputs)}, max|d| {err:.3e} (tol {TOL})")
    if not err <= TOL:
        raise RuntimeError(f"K2 disagrees with its plain version: {err}")
    kernel_ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 5)
    print(f"K2 whole take: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"({plain_ms / kernel_ms:.1f}x)")
    return err, kernel_ms, plain_ms


def fused_single(sig, NLs, NUs, band, n_plan, take, dev):
    """Phase 7: bench.py's single stereo take through restore_fused_device,
    K1 ("pallas") then K2 ("xla").  Returns each kernel's launches."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    hop = FFT // OVERLAP
    grids, times, launches = {}, {}, {}
    for backend in ("pallas", "xla"):
        def run(backend=backend):
            return rt.restore_fused_device(sig, NLs, NUs, FFT, hop, ZEROPAD, MAX_N,
                                           QUALITY, DRIFT, backend=backend,
                                           band=band, device=dev)
        reset_launches(kb)
        t0 = time.perf_counter()
        grids[backend] = run()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches[backend] = (kb.sinc_banded.launches, kb.sinc_banded_gathered.launches)
        warm, runs = wall_s(run, 5)
        times[backend] = (cold, warm, runs)
    k1, k2 = launches["pallas"][0], launches["xla"][1]
    if k1 < 1 or k2 < 1 or launches["pallas"][1] or launches["xla"][0]:
        raise RuntimeError(f"restore_fused_device launches (K1, K2): {launches}")
    err = float((grids["pallas"] - grids["xla"]).abs().max())
    out, _ = rt.compact_padded_device(grids["pallas"][0], n_plan, int(n_plan.sum()))
    before = tone_stability(take[:, 0].astype(np.float64), SR)
    after = tone_stability(out.cpu().numpy().astype(np.float64), SR)
    for backend, (cold, warm, runs) in times.items():
        print(f"restore_fused_device {backend}: grid {tuple(grids[backend].shape)}, "
              f"first call {cold:.4f} s, warm {warm * 1e3:.3f} ms "
              f"(runs {', '.join(f'{r * 1e3:.3f}' for r in runs)}), "
              f"{SECONDS / warm:.1f}x realtime")
    print(f"restore_fused_device: K1 launches {k1}, K2 launches {k2}, "
          f"pallas vs xla max|d| {err:.3e} (tol {TOL}); flutter {before:.2e} -> {after:.2e}")
    if not err <= TOL:
        raise RuntimeError(f"the K1 and K2 grids disagree: {err}")
    if not after < 0.2 * before:
        raise RuntimeError("fused restore: flutter did not drop below 0.2x the input's")
    return k1, k2


def fused_batch(mono, NLs, NUs, band, dev):
    """Phase 8: bench.py's 8-take batch through restore_fused_takes (K1),
    row 0 against its solo run; then a mixed-length batch with ``lengths``,
    each row bit-equal to its solo run.  Returns K1's launches."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    hop = FFT // OVERLAP
    B = 8
    takes = torch.stack([mono * (0.5 + 0.06 * i) for i in range(B)])
    NLb, NUb = NLs.expand(B, -1), NUs.expand(B, -1)

    def run():
        return rt.restore_fused_takes(takes, NLb, NUb, FFT, hop, ZEROPAD, MAX_N,
                                      QUALITY, DRIFT, backend="pallas", band=band,
                                      device=dev)
    reset_launches(kb)
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = kb.sinc_banded.launches
    warm, runs = wall_s(run, 5)
    solo = rt.restore_fused_device(takes[0], NLs, NUs, FFT, hop, ZEROPAD, MAX_N, QUALITY,
                                   DRIFT, backend="pallas", band=band, device=dev)
    err = float((out[0] - solo).abs().max())
    print(f"restore_fused_takes x{B}: grid {tuple(out.shape)}, K1 launches {launches}, "
          f"first call {cold:.4f} s, warm {warm * 1e3:.3f} ms "
          f"(runs {', '.join(f'{r * 1e3:.3f}' for r in runs)}), "
          f"{B * SECONDS / warm:.1f}x realtime aggregate; row 0 vs solo max|d| {err:.3e}")
    if launches < 1 or not err <= 1e-6:
        raise RuntimeError(f"8-take batch: K1 launches {launches}, row 0 vs solo {err}")
    del out, takes

    lengths = [5 * SR + 77, 3 * SR, 6 * SR]
    mixed = [torch.as_tensor(wow_take(SR, L / SR, seed=3 + i)[:L, 0], device=dev)
             for i, L in enumerate(lengths)]
    xb = torch.zeros((3, max(lengths)), dtype=torch.float32, device=dev)
    for i, x in enumerate(mixed):
        xb[i, :len(x)] = x
    F = xb.shape[1] // hop + 1
    NLm, NUm = NLs[:1].expand(3, F), NUs[:1].expand(3, F)
    out = rt.restore_fused_takes(xb, NLm, NUm, FFT, hop, ZEROPAD, MAX_N, QUALITY, DRIFT,
                                 backend="pallas", band=band, lengths=lengths, device=dev)
    for i, (L, x) in enumerate(zip(lengths, mixed)):
        Fi = L // hop + 1
        solo = rt.restore_fused_device(x, NLm[i, :Fi], NUm[i, :Fi], FFT, hop, ZEROPAD,
                                       MAX_N, QUALITY, DRIFT, backend="pallas",
                                       band=band, device=dev)
        if solo.shape[0] != L // hop or not torch.equal(out[i, :solo.shape[0]], solo):
            raise RuntimeError(f"mixed-length batch: take {i} (length {L}) differs "
                               "from its solo run")
    print(f"restore_fused_takes mixed lengths {lengths}: every row bit-equal to its "
          "solo run")
    return launches


def cli_batch():
    """Phase 9: ``respeed-batch --device cuda`` on three 10 s takes of
    unequal length; then the card against the CPU path on a small batch.
    Returns K1's launches in the CLI run."""
    from pyaudiorestoration_tpu_torch import cli
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.parallel import batch

    lengths = [10 * SR, 10 * SR - 7777, 10 * SR - 40001]
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, L in enumerate(lengths):
            paths.append(os.path.join(tmp, f"take{i}.wav"))
            wavfile.write(paths[-1], SR, wow_take(SR, L / SR, seed=10 + i)[:L, 0])
        reset_launches(kb)
        t0 = time.perf_counter()
        rc = cli.main(["respeed-batch", *paths, "--device", "cuda", "--f0", str(F0),
                       "--fft-size", str(FFT), "--step", str(FFT // OVERLAP),
                       "--zeropad", str(ZEROPAD)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kb.sinc_banded.launches
        flutter = []
        for p in paths:
            x = wavfile.read(p)[1].astype(np.float64)
            y = wavfile.read(p[:-4] + "_res.wav")[1].astype(np.float64)
            if not np.all(np.isfinite(y)) or abs(len(y) - len(x)) > 0.01 * len(x):
                raise RuntimeError(f"respeed-batch: bad output for {p}: {y.shape}")
            flutter.append((tone_stability(x, SR), tone_stability(y, SR)))
    print(f"respeed-batch --device cuda: 3 takes {lengths}, rc {rc}, K1 launches "
          f"{launches}, wall {wall:.3f} s; flutter "
          + ", ".join(f"{a:.2e} -> {b:.2e}" for a, b in flutter))
    if rc != 0 or launches < 1 or not all(b < 0.2 * a for a, b in flutter):
        raise RuntimeError("respeed-batch failed on the card")

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, L in enumerate([55_000, 48_000, 52_345]):
            paths.append(os.path.join(tmp, f"small{i}.wav"))
            wavfile.write(paths[-1], 22050, wow_take(22050, L / 22050, seed=20 + i)[:L, 0])
        kw = dict(f0_hz=F0, fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=30)
        outs = {d: batch.restore_batch_files_fused(paths, out_suffix=f"_{d}", device=d,
                                                   **kw)
                for d in ("cuda", "cpu")}
        for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
            compare_compacted(wavfile.read(a)[1], wavfile.read(b)[1],
                              f"respeed-batch cuda vs cpu, take {i} (22.05 kHz)")
    return launches


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

    # 2. build K1 and K2 (one library) from the checkout
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
    compare_compacted(*outs, "cuda vs cpu (2.5 s, 22.05 kHz)")

    # 6. K2 against its plain version at the fused path's shape
    NLs = torch.full((n_frames,), NL, dtype=torch.int32, device=dev)
    NUs = torch.full((n_frames,), NU, dtype=torch.int32, device=dev)
    band = (NL - 1, NU + 1)
    fplan = rt._fused_plan(sig[0], NLs, NUs, FFT, hop, ZEROPAD, MAX_N, QUALITY, DRIFT,
                           "blackmanharris", band)
    err2, kernel2_ms, plain2_ms = check_k2(sig, fplan)

    # 7-9. the fused single take, the batches and respeed-batch
    k1_fused, k2_fused = fused_single(sig, NLs, NUs, band, fplan[1], take, dev)
    k1_batch = fused_batch(sig[0], NLs, NUs, band, dev)
    k1_cli = cli_batch()

    common = {"route": "cuda", "source": "pyaudiorestoration_tpu_torch/csrc/sinc_banded.cu"}
    print(json.dumps({"kernels": [
        {"name": "sinc_banded", **common,
         "replaces": "pyaudiorestoration_tpu/kernels/sinc_pallas.py:253",
         "launches": k1_fused,
         "launches_by_path": {"restore_fused_device pallas": k1_fused,
                              "respeed --fast": launches,
                              "restore_fused_takes x8": k1_batch,
                              "respeed-batch": k1_cli},
         "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms},
        {"name": "sinc_banded_gathered", **common,
         "replaces": "pyaudiorestoration_tpu/kernels/sinc_pallas.py:350",
         "launches": k2_fused,
         "launches_by_path": {"restore_fused_device xla": k2_fused},
         "max_abs_err": err2, "ms": kernel2_ms, "plain_ms": plain2_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
