"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi   # phase 31 under NCCL alone, 2+ cards

Builds the port's two libraries from the checkout, in parallel: kernels K1
and K2 (the banded windowed-sinc resampler,
pyaudiorestoration_tpu_torch/csrc/sinc_banded.cu, with nvcc) and the native
audio codec (csrc/audioio.cpp, with the host C++ compiler).  Then, on a
synthesized 30 s, 192 kHz stereo wow/flutter take (fft 4096, overlap 8,
zeropad 2, sinc quality 50):

  1-2  the card, the builds
  3    K1's plan entry against its plain PyTorch version at ``respeed
       --fast``'s shape, on the take's own plan, for the take and for white
       noise through the same plan; its time beside segment_grids + the
       grid-taking entry, the plain version and its bound
  4    the ``respeed --fast`` CLI, file to file: one K1 launch
  5    that restore on the card against the port's CPU path, small take:
       the speed curves, the output from the card's curve, and the CPU's
       own output where the curves are equal
  6    K2's plan entry likewise at the fused plan's shape
  7    ``restore_fused_device`` on the stereo take, K1 then K2 (bench.py:130):
       one launch each
  8    ``restore_fused_takes`` on 8 takes (bench.py:152), one K1 launch, then
       a mixed-length batch, each row bit-equal to its solo run
  9    the ``respeed-batch`` CLI on three 10 s takes; the card against the
       CPU path on a small batch
  10   the streamed tier through the auto route: a 12-minute 192 kHz stereo
       take (1.1 GB decoded, over the 1 GiB threshold) through
       ``respeed --fast`` with no ``--stream``, one K1 launch a tile; then
       the streamed tier against the in-memory path on the 30 s take
  11   the portable path at the CLI defaults (Peak, fft 1024/8/4, sinc 50):
       ``respeed --save-project`` on the 30 s take, then the saved ``.spd``;
       K1's grid-taking entry against its plain version at ``sinc_resample``'s
       shape; the card against the CPU path on a small take
  12   the other trackers through the CLI on a 10 s 44.1 kHz take, and the
       float64 device ``sosfiltfilt`` against scipy
  13   ``heal --project`` (fft 512/16) on the 30 s take with 8 dropouts, cold
       and warm; ``--stream`` against in memory; the card against the CPU
  14   ``dropouts-batch`` Heuristic at its defaults on the 30 s take with 6
       smooth dips, with its wall split, and ``--stream``; MaxMono and
       ``--stream``
  15   ``tapesync`` at its defaults on a 60 s 44.1 kHz stereo pair (the source
       5 % fast and 60 ms late): the ratio, the batched alignment, K1's
       launches, the aligned output; K1's grid entry at ``run``'s shape
  16-24 the spectral and analysis tools through the CLI, each cold and
       warm (median of 3), on the 30 s take unless said: ``difeq`` (the
       source through a +6 dB shelf: the EQ within 1 dB of its inverse;
       streamed spectra), ``expand`` (a stepped hiss floor; defaults and
       ``--transition 8000``, each with ``--stream``), ``hpss`` (clicks
       added; H + P, ``--stream``, ``--margin 2``, the median filter's
       device time), ``renoise`` (``--selection`` and ``--stream``;
       ``--noise`` at 176.4 kHz through K1's grid entry, and at 48 kHz;
       ``sniff_offset``), ``humspeed`` (hum 1.5 % fast: the ratio, K1's grid
       entry in memory and its plan entry with ``--stream``), ``pan`` (a
       measured two-sample ``.pan``), ``decompress`` (with and without
       ``--sync``, each with ``--stream``), ``group-delay`` (a 60 s 44.1 kHz
       pair 21 samples apart) and ``cyclic-wow`` (a 60 s transfer of a
       44 rpm record)
  25   ``view`` at its defaults (fft 1024, overlap 4, izo) with ``--trail`` on
       the pilot, cold and warm: the 513 x 22,501 image, the traced curve
       within 1 % of the pilot's frequency
  26   the card's ``render_rgb`` against the port's CPU render of the same
       magnitude (at most 1e-4 of pixels one table step apart), its device
       time, the download and the host's PNG encoding
  27   ``listen`` of the take and its ``respeed --fast`` output (16-bit WAV
       payloads of the takes' lengths)
  28   ``measure`` of that pair: flutter before and after (under 0.2x), SNR,
       the spectral distance within 1e-3 dB of the CPU's
  29   ``tapesync --compare out.html`` on phase 15's pair: K1's launches as
       phase 15 counts, the red/green channels correlating above 0.99
  30   ``doctor``: healthy, its probe's K1 launch (a child process) within
       3e-5 of the plain version.  Where ``import matplotlib`` succeeds, the
       PNG forms too (``viz.save_spectrogram``, ``tapesync --compare x.png``,
       ``renoise --preview``); the script prints which ran

The mesh tier (``parallel/``) over ``torch.distributed`` ranks, each phase
printing the mesh's backend:

  31   ``restore_fused_sharded`` on phase 8's 8 takes (rows padded for the
       time axis with their reflect continuation, per-take ``lengths``):
       one rank in this process under NCCL (1 x 1), then 1 x 4 and 2 x 2
       in one spawned world of four ranks sharing the card under gloo, and
       where there are two cards or more, NCCL over up to four of them
       (else the script says it skipped that run).  K1 ("pallas") and K2
       ("xla") launch once a rank a call; every row is bit-equal to its solo
       ``restore_fused_device`` run; K1's and K2's plan entries against
       their plain versions at each rank's shard; the walls beside
       ``restore_fused_takes``'; the halo, carry and limb exchanges
  32   ``restore_file_sharded`` (2 x 2: the channels on the files axis, one
       shared curve) on the stereo take, against phase 7's output
  33   ``respeed-batch --tier fixed`` on three 10 s takes (a rank a card):
       flutter under 0.5x; ``restore_step`` with the windowed sinc on the
       1 x 4 mesh: K2's grid entry once a rank, flutter under 0.6x, the
       entry against its plain version at that shape
  34   ``lag_resample_file_sharded`` (2 x 2) on phase 15's ratio-corrected
       source and lag curve against tapesync's own export; K2's grid entry
       at that shape; the tool shards at 1 x 4 (STFT, iSTFT, HPSS, renoise,
       centre of gravity, adaptive) against the port's dense functions

Phases print on their own lines (13-34 beside the card's name and power
limit); the line before the last is a JSON object with each kernel's
launches on the main paths (the mesh's summed over its ranks), its error
against the plain version, its time, the plain version's, its bound and
share of it, at every shape, the walls of phases 13-34 and the matplotlib
forms run; the last line is ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.  Any failure raises and exits non-zero with
no result line.  Imports no JAX.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import platform
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
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
# the card's peaks for the bound (H100 SXM data sheet, dense, 700 W)
PEAK_FP32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12
FLOP_PER_TAP = 12  # sine by angle addition 3, denominator 1, reciprocal 4, quotient 2, MAC 2
SEG_TILE_STREAM = 16384  # restore_file_streamed's seg_tile


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


def cuda_ms(fn, reps, inner=1):
    """Median milliseconds of ``fn`` over ``reps`` runs, timed with CUDA
    events after one warm-up run.  ``inner`` > 1 times that many runs back
    to back between two events (the mean of them), so the host's work
    between launches overlaps the device's and the time is the device's."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
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


def card_vs_cpu_restore(rt):
    """``restore_file_fast`` on the card against the port's CPU path on a
    2.5 s 22.05 kHz take.  The tracking GEMM is float32 on both (cuBLAS; the
    host's BLAS, whose order depends on its CPU), so a frame's refined peak
    may move by a few 1e-4 bins, and a quantized log speed may round the
    other way: the exact-limb mean then moves by 2**-16 / T and scales the
    whole curve by ~5e-8 at this T, which shifts the output by up to
    hop ln2 / 65536 samples (ROADMAP queue 3).  So the speed curves are
    held within 2e-5 of each other (a hundredth of a bin at the pilot's
    bin, ~585); the card's output is held by the compacted-sample rule to
    the CPU's restore from the card's curve (``restore_file_streamed
    (speed_curve=)``: the same plan, K1's plain version, the same
    compaction); and, where the two curves are equal, to the CPU's own."""
    kw = dict(fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=30)
    small = wow_take(22050, 2.5, seed=1)
    curves, real = [], rt.plan_positions_fast

    def spy(speeds, *a, **k):  # the curve each restore plans from
        curves.append(np.asarray(speeds))
        return real(speeds, *a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        rt.plan_positions_fast = spy
        try:
            for d in ("cuda", "cpu"):
                src = os.path.join(tmp, f"{d}.wav")
                wavfile.write(src, 22050, small)
                outs.append(wavfile.read(rt.restore_file_fast(src, device=d, **kw))[1])
        finally:
            rt.plan_positions_fast = real
        src = os.path.join(tmp, "replay.wav")
        wavfile.write(src, 22050, small)
        replay = wavfile.read(rt.restore_file_streamed(src, speed_curve=curves[0],
                                                       resume=False, device="cpu",
                                                       **kw))[1]
    s_card, s_cpu = (c.astype(np.float64) for c in curves)
    rel = np.abs(s_cpu / s_card - 1.0)
    print(f"card vs cpu speed curves ({len(s_card)} frames): {int((rel > 0).sum())} differ, "
          f"max relative |d| {rel.max():.2e} (tol 2e-5)")
    if len(s_card) != len(s_cpu) or not rel.max() <= 2e-5:
        raise RuntimeError("card vs cpu: the tracked speed curves disagree")
    compare_compacted(outs[0], replay, "cuda vs cpu from the card's curve (2.5 s, 22.05 kHz)")
    if np.array_equal(s_card, s_cpu):
        compare_compacted(*outs, "cuda vs cpu (2.5 s, 22.05 kHz)")


ENTRIES = ("sinc_banded", "sinc_banded_plan", "sinc_banded_gathered",
           "sinc_banded_gathered_plan")


def reset_launches(kb):
    for name in ENTRIES:
        getattr(kb, name).launches = 0


def launches(kb):
    """Launches of (K1, K2) since the last reset, over both entries of each."""
    return (kb.sinc_banded.launches + kb.sinc_banded_plan.launches,
            kb.sinc_banded_gathered.launches + kb.sinc_banded_gathered_plan.launches)


def bound(taps, nbytes):
    """The least time the card could take, in ms, and which bounds it:
    FLOP_PER_TAP a tap at the FP32 peak, or the bytes at the HBM rate."""
    ops_ms = taps * FLOP_PER_TAP / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_plan_kernel(kernel, sig, plan, max_n, nt, drift, seed):
    """K1's (``kernel`` "K1") or K2's ("K2") plan entry on the rows of the
    (C, n) signal ``sig`` and its (T+1,) curve plan ``(speeds, n, base_int,
    base_frac)``, flattened as run_banded_sinc flattens them, against the
    plain version: for the take, then for unit-variance white noise through
    the same plan.  Times the entry, segment_grids followed by the
    grid-taking entry, and the plain version; returns the kernels-line dict."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    speeds, n, bi, bf = plan
    C, U = sig.shape[0], nt + drift
    noise = torch.randn(sig.shape, generator=torch.Generator(device=sig.device)
                        .manual_seed(seed), device=sig.device)
    errs, args = [], None
    for x in (sig, noise):
        sig_flat, s_lo, s_hi, nn, bi_f, bf_f = rt._flatten_takes(
            x, speeds.expand(C, -1), n.expand(C, -1), bi.expand(C, -1),
            bf.expand(C, -1), max_n, nt, drift)
        head = ((sig_flat, bi_f) if kernel == "K1" else
                (kb.gather_windows(sig_flat, bi_f, max_n + 2 * U, U),))
        args = (*head, s_lo, s_hi, nn, bf_f)
        entry, plain, grid_entry = ((kb.sinc_banded_plan, kb.sinc_banded_plan_plain,
                                     kb.sinc_banded) if kernel == "K1" else
                                    (kb.sinc_banded_gathered_plan,
                                     kb.sinc_banded_gathered_plan_plain,
                                     kb.sinc_banded_gathered))
        got = entry(*args, max_n, nt, drift)
        ref = plain(*args, max_n, nt, drift)
        torch.cuda.synchronize()
        errs.append(float((got - ref).abs().max()))
    rows, outputs = int(nn.shape[0]), int(nn.sum())
    print(f"{kernel} plan entry vs plain: {rows} rows x max_n {max_n}, nt {nt}, "
          f"drift {drift}: max|d| take {errs[0]:.3e}, white noise {errs[1]:.3e} "
          f"(tol {TOL})")
    if not max(errs) <= TOL:
        raise RuntimeError(f"{kernel}'s plan entry disagrees with its plain version: "
                           f"{errs}")

    def grids_then_entry():
        return grid_entry(*head, *kb.segment_grids(s_lo, s_hi, nn, bf_f, max_n), nt,
                          drift)

    # in turns: kernel, grids + grid entry, plain, kernel
    kernel_ms = cuda_ms(lambda: entry(*args, max_n, nt, drift), 10, inner=10)
    grids_ms = cuda_ms(grids_then_entry, 10, inner=10)
    plain_ms = cuda_ms(lambda: plain(*args, max_n, nt, drift), 3)
    kernel_ms2 = cuda_ms(lambda: entry(*args, max_n, nt, drift), 10, inner=10)
    taps = outputs * 2 * nt
    nbytes = (head[0].numel() * 4 + rows * 4 * (5 if kernel == "K1" else 4)
              + rows * max_n * 4)
    bound_ms, bound_by = bound(taps, nbytes)
    ms = statistics.median([kernel_ms, kernel_ms2])
    print(f"{kernel} at this shape: plan entry {kernel_ms:.4f} / {kernel_ms2:.4f} ms, "
          f"segment_grids + grid entry {grids_ms:.4f} ms, plain {plain_ms:.3f} ms; "
          f"{taps / 1e9:.4f} G taps, {nbytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms "
          f"({bound_by}), share of bound {bound_ms / ms:.3f}")
    return {"max_abs_err": max(errs), "max_abs_err_noise": errs[1], "ms": ms,
            "plain_ms": plain_ms, "grids_then_grid_entry_ms": grids_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "library_ms": None, "taps": taps, "bytes": nbytes, "rows": rows,
            "max_n": max_n}


def fused_single(sig, NLs, NUs, band, n_plan, take, dev):
    """Phase 7: bench.py's single stereo take through restore_fused_device,
    K1 ("pallas") then K2 ("xla").  Returns each kernel's launches."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    hop = FFT // OVERLAP
    grids, times, counts = {}, {}, {}
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
        counts[backend] = launches(kb)
        warm, runs = wall_s(run, 5)
        times[backend] = (cold, warm, runs)
    k1, k2 = counts["pallas"][0], counts["xla"][1]
    if counts["pallas"] != (1, 0) or counts["xla"] != (0, 1):
        raise RuntimeError(f"restore_fused_device launches (K1, K2): {counts}, "
                           "want one a take")
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
    count = launches(kb)
    warm, runs = wall_s(run, 5)
    solo = rt.restore_fused_device(takes[0], NLs, NUs, FFT, hop, ZEROPAD, MAX_N, QUALITY,
                                   DRIFT, backend="pallas", band=band, device=dev)
    err = float((out[0] - solo).abs().max())
    print(f"restore_fused_takes x{B}: grid {tuple(out.shape)}, K1 launches {count[0]}, "
          f"first call {cold:.4f} s, warm {warm * 1e3:.3f} ms "
          f"(runs {', '.join(f'{r * 1e3:.3f}' for r in runs)}), "
          f"{B * SECONDS / warm:.1f}x realtime aggregate; row 0 vs solo max|d| {err:.3e}")
    if count != (1, 0) or not err <= 1e-6:
        raise RuntimeError(f"8-take batch: launches {count}, row 0 vs solo {err}")
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
    return count[0]


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
        count = launches(kb)
        flutter = []
        for p in paths:
            x = wavfile.read(p)[1].astype(np.float64)
            y = wavfile.read(p[:-4] + "_res.wav")[1].astype(np.float64)
            if not np.all(np.isfinite(y)) or abs(len(y) - len(x)) > 0.01 * len(x):
                raise RuntimeError(f"respeed-batch: bad output for {p}: {y.shape}")
            flutter.append((tone_stability(x, SR), tone_stability(y, SR)))
    print(f"respeed-batch --device cuda: 3 takes {lengths} in one group, rc {rc}, "
          f"K1 launches {count[0]}, wall {wall:.3f} s; flutter "
          + ", ".join(f"{a:.2e} -> {b:.2e}" for a, b in flutter))
    if rc != 0 or count != (1, 0) or not all(b < 0.2 * a for a, b in flutter):
        raise RuntimeError(f"respeed-batch failed on the card: rc {rc}, launches {count}")

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
    return count[0]


LONG_MINUTES = 12  # 1.106 GB decoded at 192 kHz stereo float32: over 1 GiB


def long_wow_chunks(sr, n, dev, chunk=1 << 24, seed=0):
    """wow_take's tone (0.8 % wow at 0.55 Hz, 0.15 % flutter at 6.3 Hz),
    synthesized on the card in ``chunk``-sample (chunk, 2) float32 pieces
    from the closed-form phase, so no piece depends on the one before."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w1, w2 = 2 * math.pi * 0.55, 2 * math.pi * 6.3
    for a in range(0, n, chunk):
        t = torch.arange(a, min(n, a + chunk), dtype=torch.float64, device=dev) / sr
        phase = 2 * math.pi * F0 * (t + 0.008 / w1 * (1 - torch.cos(w1 * t))
                                    + 0.0015 / w2 * (math.cos(1.0) - torch.cos(w2 * t + 1.0)))
        noise = torch.randn(t.shape, generator=gen, dtype=torch.float64, device=dev)
        mono = (0.5 * torch.sin(phase) + 1e-3 * noise).to(torch.float32)
        yield torch.stack([mono, 0.8 * mono], -1).cpu().numpy()


def write_float_wav(path, sr, channels, n, chunks):
    """A float32 WAV (format 3) header, then ``chunks`` written in turn."""
    data = n * channels * 4
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + data) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, channels, sr, sr * channels * 4,
                                      channels * 4, 32))
        f.write(b"data" + struct.pack("<I", data))
        for block in chunks:
            f.write(np.ascontiguousarray(block, dtype="<f4").tobytes())


def head(path, seconds):
    """The first ``seconds`` of a WAV, channel 0, as float64."""
    sr, data = wavfile.read(path, mmap=True)
    return np.array(data[:int(seconds * sr), 0], dtype=np.float64)


def streamed_phase(take, dev):
    """Phase 10: the 12-minute take through ``respeed --fast`` (auto route to
    the streamed tier), then the streamed tier against the in-memory path on
    the 30 s take.  Returns K1's launches in the 12-minute run."""
    from pyaudiorestoration_tpu_torch import cli
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    n = int(LONG_MINUTES * 60 * SR)
    tiles = -(-(n // (FFT // OVERLAP)) // SEG_TILE_STREAM)  # one K1 launch a tile
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "long.wav")
        t0 = time.perf_counter()
        write_float_wav(src, SR, 2, n, long_wow_chunks(SR, n, dev))
        synth_s = time.perf_counter() - t0
        size = os.path.getsize(src)
        timings, real = {}, rt.restore_file_streamed

        def spy(*a, **k):
            return real(*a, timings=timings, **k)

        rt.restore_file_streamed = spy
        try:
            reset_launches(kb)
            t0 = time.perf_counter()
            rc = cli.main(["respeed", src, "--fast", "--device", "cuda", "--fft-size",
                           str(FFT), "--fft-overlap", str(OVERLAP), "--zeropad",
                           str(ZEROPAD), "--sinc-quality", str(QUALITY)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            rt.restore_file_streamed = real
        count = launches(kb)
        out = os.path.join(tmp, "long_res.wav")
        n_out = len(wavfile.read(out, mmap=True)[1])
        before, after = (tone_stability(head(p, 30.0), SR) for p in (src, out))
    print(f"streamed tier, auto route: {LONG_MINUTES} min 192 kHz stereo, "
          f"{size / 1e9:.3f} GB on disk (synthesized and written in {synth_s:.1f} s); "
          f"rc {rc}, K1 launches {count[0]} (tiles {tiles}), "
          f"pass 1 {timings.get('pass1_s', 0):.3f} s "
          f"(read {timings.get('pass1_read_s', 0):.3f}, device "
          f"{timings.get('pass1_device_s', 0):.3f}), plan {timings.get('plan_s', 0):.3f} s, "
          f"pass 2 {timings.get('pass2_s', 0):.3f} s (read "
          f"{timings.get('pass2_read_s', 0):.3f}, device "
          f"{timings.get('pass2_device_dl_s', 0):.3f}, write "
          f"{timings.get('pass2_write_s', 0):.3f}), wall {wall:.3f} s, "
          f"{n / SR / wall:.1f}x realtime; output {n_out} frames of {n}; "
          f"flutter (first 30 s) {before:.2e} -> {after:.2e}")
    if rc != 0 or count != (tiles, 0) or "pass2_s" not in timings:
        raise RuntimeError(f"streamed restore: rc {rc}, launches {count} for {tiles} "
                           f"tiles, timings {sorted(timings)}")
    if abs(n_out - n) > 0.01 * n or not after < 0.2 * before:
        raise RuntimeError("streamed restore: bad length or flutter")

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "take.wav")
        wavfile.write(src, SR, take)
        kw = dict(fft_size=FFT, fft_overlap=OVERLAP, zeropad=ZEROPAD,
                  sinc_quality=QUALITY, device=dev)
        a = wavfile.read(rt.restore_file_fast(src, suffix="_mem", stream=False, **kw))[1]
        b = wavfile.read(rt.restore_file_streamed(src, suffix="_str", **kw))[1]
    err = float(np.abs(a - b).max()) if a.shape == b.shape else math.inf
    print(f"streamed vs in-memory ({SECONDS:.0f} s take): shapes {a.shape} / {b.shape}, "
          f"max|d| {err:.3e} (tol 1e-5)")
    if not err <= 1e-5:
        raise RuntimeError("the streamed tier disagrees with the in-memory path")
    return count[0]


def timed_cli(argv, reps):
    """``cli.main(argv)`` once cold and ``reps`` times warm; returns (K1
    launches of the cold run, cold s, median warm s, warm runs)."""
    from pyaudiorestoration_tpu_torch import cli
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb

    reset_launches(kb)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    count = launches(kb)
    if rc != 0:
        raise RuntimeError(f"{argv}: rc {rc}")
    warm, runs = wall_s(lambda: cli.main(argv), reps)
    return count[0], cold, warm, runs


def portable_phase(take, sig, dev):
    """Phase 11: ``respeed --save-project`` and the ``.spd`` replay at the CLI
    defaults on the 30 s take; K1 at ``sinc_resample``'s shape; the card
    against the CPU path.  Returns (K1 launches of the two runs, K1 check)."""
    from pyaudiorestoration_tpu_torch.ops import resampling as rs
    from pyaudiorestoration_tpu_torch.pipelines import respeeder as rp
    from pyaudiorestoration_tpu_torch.utils import project

    n = take.shape[0]
    before = tone_stability(take[:, 0].astype(np.float64), SR)
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "take.wav")
        wavfile.write(src, SR, take)
        spd = src[:-4] + ".spd"
        for name, argv in (("respeed (Peak)", ["respeed", src, "--device", "cuda",
                                               "--save-project"]),
                           ("respeed .spd", ["respeed", spd, "--device", "cuda"])):
            k1, cold, warm, runs = timed_cli(argv, 3)
            out = wavfile.read(os.path.join(tmp, "take_res.wav"))[1]
            after = tone_stability(out[:, 0].astype(np.float64), SR)
            counts[name] = k1
            print(f"{name}: {SECONDS:.0f} s take at the CLI defaults, K1 launches {k1}, "
                  f"cold {cold:.3f} s, warm {warm:.3f} s "
                  f"(runs {', '.join(f'{r:.3f}' for r in runs)}), "
                  f"{SECONDS / warm:.1f}x realtime; output {out.shape}; "
                  f"flutter {before:.2e} -> {after:.2e}")
            if k1 < 1 or not np.all(np.isfinite(out)) or abs(len(out) - n) > 0.01 * n:
                raise RuntimeError(f"{name}: K1 launches {k1}, output {out.shape}")
            if not after < 0.2 * before:
                raise RuntimeError(f"{name}: flutter did not drop below 0.2x the input's")
        proj = project.Project.load(spd)
        curve = rp.get_speed_curve(proj.marker_list("lines"), [], SR, proj.hop, n / SR)

    # K1 on the banded branch's own inputs, one launch per channel
    k1 = k1_grid_check(sig, rs.speed_to_pos(curve[:, 0] * SR, curve[:, 1], n),
                       "sinc_resample (portable respeed)", all_lanes=True)

    small = wow_take(22050, 2.5, seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        outs = []
        for d in ("cuda", "cpu"):
            src = os.path.join(tmp, f"{d}.wav")
            wavfile.write(src, 22050, small)
            outs.append(wavfile.read(rp.restore_file(
                src, fft_size=2048, fft_overlap=8, zeropad=2, sinc_quality=30,
                device=d)[0])[1][:, 0])
    compare_compacted(*outs, "portable respeed cuda vs cpu (2.5 s, 22.05 kHz)")
    return counts, k1


def k1_grid_check(sig, pos, what, nt=QUALITY, all_lanes=False):
    """K1's grid entry on ``sinc_resample``'s banded inputs for the float64
    positions ``pos`` and ``nt`` taps a side, one launch per row of the
    (C, n) signal ``sig``, against its plain version; its time, bound and
    share.  Taps are the real outputs' (every lane's, padding included,
    with ``all_lanes``)."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.ops import resampling as rs

    dev = sig.device
    layout = rs.banded_layout(pos, rs._positions_to_device_args(pos)[2])
    if layout is None:
        raise RuntimeError(f"{what}: the positions leave sinc_resample's banded branch")
    anchors, rel, fc, drift = layout
    anchors, rel, fc = (torch.as_tensor(v, device=dev) for v in (anchors, rel, fc))
    lanes = torch.ones(rel.shape, dtype=torch.bool, device=dev)

    def run(fn):
        return [fn(ch, anchors, fc, rel, lanes, nt, drift) for ch in sig]

    err = max(float((g - r).abs().max())
              for g, r in zip(run(kb.sinc_banded), run(kb.sinc_banded_plain)))
    kernel_ms = cuda_ms(lambda: run(kb.sinc_banded), 10, inner=10)
    plain_ms = cuda_ms(lambda: run(kb.sinc_banded_plain), 3)
    taps = len(sig) * (rel.numel() if all_lanes else len(pos)) * 2 * nt
    nbytes = len(sig) * (sig[0].numel() * 4 + anchors.numel() * 4 + rel.numel() * 13)
    bound_ms, bound_by = bound(taps, nbytes)
    print(f"K1 grid entry vs plain at {what}: {len(sig)} x {tuple(rel.shape)}, nt "
          f"{nt}, drift {drift}, max|d| {err:.3e} (tol {TOL}); kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.3f} ms; {taps / 1e9:.4f} G taps, "
          f"{nbytes / 1e6:.1f} MB, bound {bound_ms:.4f} ms ({bound_by}), share "
          f"{bound_ms / kernel_ms:.3f}")
    if not err <= TOL:
        raise RuntimeError(f"K1 disagrees with its plain version at {what}: {err}")
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / kernel_ms, "library_ms": None, "taps": taps,
            "bytes": nbytes, "rows": int(rel.shape[0]), "nt": nt, "drift": drift}


def modes_phase(dev):
    """Phase 12: the other trackers through the CLI on a 10 s 44.1 kHz
    take, then the float64 device sosfiltfilt against scipy."""
    from scipy import signal as dsp

    from pyaudiorestoration_tpu_torch import cli
    from pyaudiorestoration_tpu_torch.ops import filters

    sr = 44100
    take = wow_take(sr, 10.0, seed=5)
    n = take.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "short.wav")
        wavfile.write(src, sr, take)
        for i, (mode, extra) in enumerate([
                ("Peak Track", []), ("Center of Gravity", []), ("Zero-Crossing", []),
                ("Correlation", []), ("Freehand Draw", []),
                ("Peak", ["--adaptation", "Linear"])]):
            t0 = time.perf_counter()
            rc = cli.main(["respeed", src, "--device", "cuda", "--mode", mode, *extra,
                           "--suffix", f"_{i}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out = wavfile.read(os.path.join(tmp, f"short_res_{i}.wav"))[1]
            print(f"respeed --mode {mode!r} {' '.join(extra)}: rc {rc}, wall {wall:.3f} s, "
                  f"output {out.shape}")
            if rc != 0 or not np.all(np.isfinite(out)) or abs(len(out) - n) > 0.02 * n:
                raise RuntimeError(f"respeed --mode {mode}: rc {rc}, output {out.shape}")

    x = (0.3 * np.random.default_rng(1234).standard_normal(1 << 16)).astype(np.float32)
    worst = math.inf
    for lo, hi in [(100, 147), (681, 1000), (40, 80)]:
        sos = dsp.butter(3, [lo / (sr / 2), hi / (sr / 2)], btype="band", output="sos")
        ref = dsp.sosfiltfilt(sos, x.astype(np.float64))
        got = filters.sosfiltfilt(sos, x, device=dev).cpu().numpy().astype(np.float64)
        worst = min(worst, 10 * math.log10(np.sum(ref ** 2)
                                           / max(np.sum((got - ref) ** 2), 1e-300)))
    ms = cuda_ms(lambda: filters.sosfiltfilt(sos, torch.as_tensor(x, device=dev)), 5)
    print(f"sosfiltfilt float64 scan on the card: worst of 3 cascades {worst:.1f} dB "
          f"against scipy (gate 100 dB); {len(x)} samples {ms:.3f} ms")
    if not worst > 100.0:
        raise RuntimeError(f"device sosfiltfilt at {worst:.1f} dB against scipy")


N_DROPS, DROP_S = 8, 0.004  # heal: 8 dropouts, x0.05 over 4 ms each
N_DIPS, DIP_S = 6, 0.030    # dropouts-batch: smooth 30 ms dips
TS_SR, TS_SECONDS, TS_DELAY = 44100, 60.0, 0.060  # tapesync's pair


def walls(fn, reps):
    """``fn()`` once cold and ``reps`` times warm, each ending in a
    synchronize: (cold s, median warm s, warm runs)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    return (cold, *wall_s(fn, reps))


def run_cli(argv):
    """``cli.main(argv)``'s JSON result line, not echoed (it must return 0)."""
    from pyaudiorestoration_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"{argv}: rc {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def dropout_take(sr, seconds, n_drops, seed=0):
    """wow_take with ``n_drops`` dropouts (x0.05 over DROP_S) spread over the
    take, and the .drop boxes naming them (1-8 kHz, 1.5 ms either side)."""
    take = wow_take(sr, seconds, seed)
    times = np.linspace(0.1 * seconds, 0.9 * seconds, n_drops)
    for t in times:
        take[int(t * sr):int(t * sr) + int(DROP_S * sr)] *= 0.05
    boxes = [((t - 0.0015, 1000.0), (t + DROP_S + 0.0015, 8000.0)) for t in times]
    return take, times, boxes


def save_drop(path, boxes):
    from pyaudiorestoration_tpu_torch.models import markers as mk
    from pyaudiorestoration_tpu_torch.utils import project

    project.Project(".drop", {"fft_size": 512, "fft_overlap": 16}, {
        "dropouts": [mk.DropoutSample(a, b, 0.5) for a, b in boxes]}).save(path)


def rms(x, sr, t0, t1):
    return float(np.sqrt(np.mean(np.square(x[int(t0 * sr):int(t1 * sr)], dtype=np.float64))))


def heal_phase(dev, smi):
    """Phase 13: ``heal --project`` at the CLI defaults (fft 512, overlap 16)
    on the 30 s take with 8 dropouts, cold and median of 3 warm; the
    dropouts' level must rise; ``--stream`` against the in-memory file
    (interior within 1e-4, tests/test_streaming_tools.py:83); the card
    against the CPU path on a 2.5 s 22.05 kHz take (within 1e-4)."""
    from pyaudiorestoration_tpu_torch.models import markers as mk
    from pyaudiorestoration_tpu_torch.pipelines import dropouts
    from pyaudiorestoration_tpu_torch.utils import audio_io

    take, times, boxes = dropout_take(SR, SECONDS, N_DROPS)
    with tempfile.TemporaryDirectory() as tmp:
        src, drop = os.path.join(tmp, "take.wav"), os.path.join(tmp, "take.drop")
        wavfile.write(src, SR, take)
        save_drop(drop, boxes)
        argv = ["heal", src, "--project", drop, "--device", str(dev)]
        cold, warm, runs = walls(lambda: run_cli(argv), 3)
        out = audio_io.read_file(os.path.join(tmp, "take_drops.wav"))[0]
        t0 = time.perf_counter()
        run_cli(argv + ["--stream", "--suffix", "_str"])
        stream_s = time.perf_counter() - t0
        streamed = audio_io.read_file(os.path.join(tmp, "take_drops_str.wav"))[0]
    lift = min(rms(out[:, 0], SR, t + 0.0005, t + DROP_S - 0.0005)
               / rms(take[:, 0], SR, t + 0.0005, t + DROP_S - 0.0005) for t in times)
    err = float(np.abs(out[512:-512] - streamed[512:-512]).max()) \
        if out.shape == streamed.shape == take.shape else math.inf
    print(f"[{smi}] heal --project ({N_DROPS} dropouts, {SECONDS:.0f} s {SR} Hz stereo, "
          f"fft 512/16): cold {cold:.3f} s, warm {warm:.3f} s (runs "
          f"{', '.join(f'{r:.3f}' for r in runs)}), {SECONDS / warm:.1f}x realtime; "
          f"--stream {stream_s:.3f} s, streamed vs in-memory interior max|d| {err:.3e} "
          f"(tol 1e-4); least level lift in a dropout {lift:.2f}x")
    if not np.all(np.isfinite(out)) or not lift > 4.0:
        raise RuntimeError(f"heal: output finite {np.all(np.isfinite(out))}, lift {lift}")
    if not err <= 1e-4:
        raise RuntimeError(f"heal --stream disagrees with the in-memory heal: {err}")

    small, _, sboxes = dropout_take(22050, 2.5, 2, seed=6)
    drops = [mk.DropoutSample(a, b, 0.5) for a, b in sboxes]
    outs = [dropouts.heal(small, 22050, drops, device=d) for d in (str(dev), "cpu")]
    err = float(np.abs(outs[0] - outs[1]).max())
    print(f"heal card vs cpu (2.5 s, 22.05 kHz): max|d| {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise RuntimeError(f"heal on the card disagrees with the CPU path: {err}")
    return {"cold_s": cold, "warm_s": warm, "stream_s": stream_s}


def dips_take(sr, seconds, n_dips, seed=0):
    """wow_take with ``n_dips`` smooth (hann-shaped, 95 %) dips of DIP_S
    (tests/test_host_loop_removal.py:119-150's shape); returns the take
    and the dips' centres."""
    take = wow_take(sr, seconds, seed)
    centres = np.linspace(0.1 * seconds, 0.9 * seconds, n_dips)
    w = int(DIP_S / 2 * sr)
    for c in centres:
        c = int(c * sr)
        take[c - w:c + w] *= (1.0 - 0.95 * np.hanning(2 * w)).astype(np.float32)[:, None]
    return take, centres


def dropouts_batch_phase(dev, smi):
    """Phase 14: ``dropouts-batch --mode Heuristic`` at the defaults (fft
    1024/4, 12 bands, 3-12 kHz) on the 30 s take with 6 dips, cold and warm,
    and its wall split (spectrum, host ``_heuristic_fac``, float64 band
    cascade); the dips must rise; ``--stream`` against in memory (interior
    within 1e-5, tests/test_streaming_tools.py:157); ``--mode MaxMono`` in
    memory against ``--stream`` (within 1e-5)."""
    from pyaudiorestoration_tpu_torch.pipelines import dropouts
    from pyaudiorestoration_tpu_torch.utils import audio_io

    take, centres = dips_take(SR, SECONDS, N_DIPS)
    take[:, 1] += 0.2 * np.sin(2 * np.pi * 5000 * np.arange(len(take)) / SR).astype(
        np.float32)  # the channels differ, so the max/min folds do
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "dips.wav")
        wavfile.write(src, SR, take)
        argv = ["dropouts-batch", src, "--device", str(dev)]
        split, real = {}, dropouts.process_heuristic

        def spy(*a, **k):  # the entry's own split, of the last warm run
            return real(*a, timings=split, **k)

        dropouts.process_heuristic = spy
        try:
            cold, warm, runs = walls(lambda: run_cli(argv), 2)
        finally:
            dropouts.process_heuristic = real
        out = audio_io.read_file(os.path.join(tmp, "dips_out.wav"))[0]
        t0 = time.perf_counter()
        run_cli(argv + ["--stream", "--suffix", "_str"])
        stream_s = time.perf_counter() - t0
        streamed = audio_io.read_file(os.path.join(tmp, "dips_str.wav"))[0]
        h = 4096
        err = float(np.abs(out[h:-h] - streamed[h:-h]).max()) \
            if out.shape == streamed.shape == take.shape else math.inf
        lift = min(rms(out[:, 0], SR, c - 0.003, c + 0.003)
                   / rms(take[:, 0], SR, c - 0.003, c + 0.003) for c in centres)
        print(f"[{smi}] dropouts-batch Heuristic ({N_DIPS} dips, {SECONDS:.0f} s {SR} Hz "
              f"stereo, defaults): cold {cold:.3f} s, warm {warm:.3f} s (runs "
              f"{', '.join(f'{r:.3f}' for r in runs)}); split: spectrum "
              f"{split['spectrum_s']:.3f} s, host _heuristic_fac "
              f"{split['heuristic_fac_s']:.3f} s, float64 cascade {split['cascade_s']:.3f} s; "
              f"--stream {stream_s:.3f} s, interior max|d| {err:.3e} (tol 1e-5); least "
              f"lift at a dip centre {lift:.2f}x")
        if not np.all(np.isfinite(out)) or not lift > 1.5:
            raise RuntimeError(f"heuristic: output finite {np.all(np.isfinite(out))}, "
                               f"lift {lift}")
        if not err <= 1e-5:
            raise RuntimeError(f"dropouts-batch --stream disagrees with in memory: {err}")
        res["heuristic"] = {"cold_s": cold, "warm_s": warm, "stream_s": stream_s,
                            **split}

        mono = ["dropouts-batch", src, "--mode", "MaxMono", "--device", str(dev)]
        cold, warm, runs = walls(lambda: run_cli(mono), 2)
        t0 = time.perf_counter()
        run_cli(mono + ["--stream", "--suffix", "_str"])
        stream_s = time.perf_counter() - t0
        errs = []
        for fold in ("max", "min"):
            a = audio_io.read_file(os.path.join(tmp, f"dips{fold}.wav"))[0]
            b = audio_io.read_file(os.path.join(tmp, f"dips{fold}_str.wav"))[0]
            if a.shape != (len(take), 1) or a.shape != b.shape or not np.all(np.isfinite(a)):
                raise RuntimeError(f"MaxMono {fold}: shapes {a.shape} / {b.shape}")
            errs.append(float(np.abs(a - b).max()))
        print(f"[{smi}] dropouts-batch MaxMono: cold {cold:.3f} s, warm {warm:.3f} s; "
              f"--stream {stream_s:.3f} s; streamed vs in-memory max|d| max {errs[0]:.3e}, "
              f"min {errs[1]:.3e} (tol 1e-5)")
        if not max(errs) <= 1e-5:
            raise RuntimeError(f"MaxMono --stream disagrees with in memory: {errs}")
        res["max_mono"] = {"cold_s": cold, "warm_s": warm, "stream_s": stream_s}
    return res


def tapesync_pair(sr, seconds, seed=0):
    """A stereo reference of band-limited noise (100 Hz - 8 kHz) plus tones,
    and the source: the reference delayed by TS_DELAY and played 5 % fast
    (``resample_poly(., 20, 21)``), the shape of the reference tool's
    rhythm.flac against rhythm+5percent.flac."""
    from scipy import signal as dsp

    n = int(seconds * sr)
    rng = np.random.default_rng(seed)
    sos = dsp.butter(4, [100 / (sr / 2), 8000 / (sr / 2)], btype="band", output="sos")
    noise = dsp.sosfilt(sos, rng.standard_normal((n, 2)), axis=0)
    t = np.arange(n) / sr
    tones = sum(np.sin(2 * np.pi * f * t + p) for f, p in ((220.0, 0.0), (554.4, 1.0),
                                                            (1318.5, 2.0)))
    ref = (0.3 * noise / np.abs(noise).max() + 0.1 * tones[:, None]).astype(np.float32)
    delayed = np.concatenate([np.zeros((int(TS_DELAY * sr), 2), np.float32), ref])
    return ref, dsp.resample_poly(delayed, 20, 21, axis=0).astype(np.float32)


def tapesync_phase(dev, smi):
    """Phase 15: ``tapesync`` at the defaults (8 windows of 1 s, lower 100 Hz,
    sinc 50) on the 60 s 44.1 kHz pair, cold and warm: the speed ratio
    1.05 +- 0.01 (tests/test_pipelines.py:24), the batched ``auto_align``
    path taken with no per-window fallback, its lags within 0.5 ms of the
    truth t - (t + TS_DELAY) / 1.05, K1's launches in ``resample_ratio``
    and in ``run``, the aligned output correlating with the reference above
    0.8 within 2 samples of lag 0; then K1's grid entry at both of the
    path's shapes (the stacked windows at nt 8, ``run``'s at nt 50) against
    its plain version."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.ops import correlation, resampling as rs
    from pyaudiorestoration_tpu_torch.pipelines import tapesynch as ts
    from pyaudiorestoration_tpu_torch.utils import audio_io

    ref, src_sig = tapesync_pair(TS_SR, TS_SECONDS)
    seen = {"ratio": [], "batched": 0, "fallback": 0, "k1 resample_ratio": 0, "k1 run": 0,
            "samples": None, "lag_curve": None}
    calls = []  # sinc_resample's (C, n) signal, positions and nt in the first run
    real = {"ratio": ts.estimate_speed_ratio, "batch": correlation.find_delay_batch,
            "window": ts.correlate_sources, "align": ts.auto_align,
            "resample_ratio": rs.resample_ratio, "run": rs.run, "sinc": rs.sinc_resample}

    def ratio(*a, **k):
        seen["ratio"].append(real["ratio"](*a, **k))
        return seen["ratio"][-1]

    def batch(*a, **k):
        seen["batched"] += 1
        return real["batch"](*a, **k)

    def window(*a, **k):
        seen["fallback"] += 1
        return real["window"](*a, **k)

    def align(*a, **k):
        out = real["align"](*a, **k)
        seen["samples"], seen["lag_curve"] = out[0], out[1]
        return out

    def sinc(signal, sample_at, **k):
        if len(calls) < 2:  # the first run's two calls
            rows = torch.as_tensor(signal, dtype=torch.float32, device=dev)
            calls.append((rows.T.clone(memory_format=torch.contiguous_format),
                          np.array(sample_at, np.float64), k["quality"]))
        return real["sinc"](signal, sample_at, **k)

    def counted(name, key):
        def fn(*a, **k):
            before = launches(kb)[0]
            out = real[name](*a, **k)
            seen[key] += launches(kb)[0] - before
            return out
        return fn

    ts.estimate_speed_ratio, correlation.find_delay_batch = ratio, batch
    ts.correlate_sources, ts.auto_align, rs.sinc_resample = window, align, sinc
    rs.resample_ratio = counted("resample_ratio", "k1 resample_ratio")
    rs.run = counted("run", "k1 run")
    try:
        with tempfile.TemporaryDirectory() as tmp:
            r, s = os.path.join(tmp, "ref.wav"), os.path.join(tmp, "src.wav")
            wavfile.write(r, TS_SR, ref)
            wavfile.write(s, TS_SR, src_sig)
            argv = ["tapesync", r, s, "--device", str(dev)]
            run_cli(argv)
            first = dict(seen)
            cold, warm, runs = walls(lambda: run_cli(argv), 3)
            out = audio_io.read_file(os.path.join(tmp, "src_res.wav"))[0]
    finally:
        ts.estimate_speed_ratio, correlation.find_delay_batch = real["ratio"], real["batch"]
        ts.correlate_sources, ts.auto_align = real["window"], real["align"]
        rs.resample_ratio, rs.run, rs.sinc_resample = (real["resample_ratio"], real["run"],
                                                       real["sinc"])
    corrs = []
    w = TS_SR // 2
    for frac in (0.25, 0.5, 0.75):
        mid = int(frac * min(len(out), len(ref)))
        d, c = correlation.find_delay(ref[mid - w:mid + w, 0], out[mid - w:mid + w, 0],
                                      window_name="hann", device=dev)
        corrs.append((float(d), float(c)))
    lag_err = max(abs(x.d - (x.t - (x.t + TS_DELAY) / 1.05)) for x in first["samples"])
    n_rr, n_run = first["k1 resample_ratio"], first["k1 run"]
    print(f"[{smi}] tapesync ({TS_SECONDS:.0f} s {TS_SR} Hz stereo, 5 % fast, "
          f"{TS_DELAY * 1e3:.0f} ms late; defaults): cold {cold:.3f} s, warm {warm:.3f} s "
          f"(runs {', '.join(f'{x:.3f}' for x in runs)}); ratio {first['ratio'][0]:.5f}; "
          f"batched find_delay calls {first['batched']}, per-window fallbacks "
          f"{first['fallback']}; {len(first['samples'])} lags, worst vs truth "
          f"{lag_err * 1e3:.4f} ms (tol 0.5 ms); K1 launches: resample_ratio {n_rr}, "
          f"run {n_run}; output {out.shape}; output vs reference (delay samples, corr) "
          + ", ".join(f"({d:.3f}, {c:.4f})" for d, c in corrs))
    if not abs(first["ratio"][0] - 1.05) <= 0.01:
        raise RuntimeError(f"tapesync ratio estimate {first['ratio']}")
    if first["batched"] != 1 or first["fallback"] != 0:
        raise RuntimeError(f"auto_align: {first['batched']} batched calls, "
                           f"{first['fallback']} per-window fallbacks")
    if len(first["samples"]) != 8 or not lag_err <= 5e-4:
        raise RuntimeError(f"auto_align: {len(first['samples'])} lags, worst {lag_err} s "
                           f"from the truth")
    if n_rr < 1 or n_run < 1 or not np.all(np.isfinite(out)):
        raise RuntimeError(f"tapesync: K1 launches {n_rr} / {n_run}, output finite "
                           f"{np.all(np.isfinite(out))}")
    if not all(c > 0.8 and abs(d) < 2.0 for d, c in corrs):
        raise RuntimeError(f"tapesync: output vs reference {corrs}")
    if [nt for *_, nt in calls] != [8, QUALITY]:
        raise RuntimeError(f"tapesync: sinc_resample called at nt {[c[2] for c in calls]}")
    k1 = {name: k1_grid_check(sig, pos, f"tapesync's {name}", nt=nt)
          for name, (sig, pos, nt) in zip(("resample_ratio", "run"), calls)}
    export = (calls[1][0].cpu().numpy(), np.asarray(first["lag_curve"], np.float64))
    return {"cold_s": cold, "warm_s": warm, "ratio": first["ratio"][0],
            "lag_err_s": lag_err, "k1 resample_ratio": n_rr, "k1 run": n_run}, k1, export


# ---------------------------------------------------------------------------
# Phases 16-24: the spectral and analysis tools through the CLI
# ---------------------------------------------------------------------------

def tool_walls(name, argv, smi, reps=3, seconds=SECONDS):
    """Phase walls of one CLI run on a ``seconds`` take: cold, then the
    median of ``reps`` warm runs; K1's launches in the cold run.  Prints
    them beside the card."""
    with contextlib.redirect_stdout(io.StringIO()):
        k1, cold, warm, runs = timed_cli(argv, reps)
    print(f"[{smi}] {name}: cold {cold:.3f} s, warm {warm:.3f} s (runs "
          f"{', '.join(f'{r:.3f}' for r in runs)}), {seconds / warm:.1f}x realtime; "
          f"K1 launches {k1}")
    return {"cold_s": cold, "warm_s": warm, "k1_launches": k1}


def interior_err(a, b, h):
    """max |a - b| away from ``h`` samples at either end (inf on a shape
    mismatch)."""
    if a.shape != b.shape:
        return math.inf
    return float(np.abs(a[h:-h] - b[h:-h]).max())


def require(ok, what):
    if not ok:
        raise RuntimeError(what)


def shelf(sr, f0=2000.0, gain=2.0):
    """A first-order high shelf (+6 dB above ``f0``), bilinear: (b, a)."""
    from scipy import signal as dsp

    w0 = 2 * math.pi * f0
    return dsp.bilinear([gain, w0], [1.0, w0], fs=sr)


def difeq_phase(take, dev, smi):
    """Phase 16: ``difeq`` on a 30 s pair at fft 16384 / hop 8192 (get_eq's
    defaults), the source the take through a +6 dB high shelf: the
    recovered EQ within 1 dB of the shelf's inverse response over
    100 Hz-20 kHz; the streamed mean spectra within 1e-3 dB of in memory."""
    from scipy import signal as dsp

    from pyaudiorestoration_tpu_torch.models import spectrum_flat
    from pyaudiorestoration_tpu_torch.pipelines import difeq

    b, a = shelf(SR)
    src_sig = dsp.lfilter(b, a, take, axis=0).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ref, src = os.path.join(tmp, "ref.wav"), os.path.join(tmp, "src.wav")
        wavfile.write(ref, SR, take)
        wavfile.write(src, SR, src_sig)
        argv = ["difeq", src, ref, "-o", os.path.join(tmp, "eq"), "--device", str(dev)]
        res = tool_walls("difeq (30 s pair, fft 16384/8192)", argv, smi)
        for path in run_cli(argv)["outputs"]:
            with open(path) as f:
                text = f.read()
            require(text.startswith("FilterCurve:") and "nan" not in text,
                    f"difeq: bad curve file {path}")
        freqs, eq = difeq.get_eq(src, ref, "L+R", device=dev)
        _, h = dsp.freqz(b, a, worN=freqs, fs=SR)
        band = (freqs >= 100) & (freqs <= 20000)
        err = float(np.abs(eq[:, band] + 20 * np.log10(np.abs(h[band]))).max())
        mem, _ = spectrum_flat.spectra_from_audio(ref, 16384, 8192, "L+R", stream=False,
                                                  device=dev)
        streamed, _ = spectrum_flat.spectra_from_audio(ref, 16384, 8192, "L+R",
                                                       stream=True, device=dev)
        err_s = max(float(np.abs(x - y).max()) for x, y in zip(mem, streamed))
    print(f"difeq: recovered EQ vs the shelf's inverse over 100 Hz-20 kHz max|d| "
          f"{err:.4f} dB (tol 1 dB); streamed vs in-memory spectra max|d| {err_s:.2e} dB "
          f"(tol 1e-3)")
    require(err <= 1.0, f"difeq: EQ {err} dB from the filter's response")
    require(err_s <= 1e-3, f"difeq: streamed spectra {err_s} dB from in memory")
    return {**res, "eq_err_db": err, "stream_err_db": err_s}


def hiss_take(sr, seconds, seed=0):
    """wow_take's tone at -50 dBFS (at 192 kHz and fft 512 a 0.5 tone's
    window leakage reaches -90 dB in the expander's 13-17 kHz band) over a
    hiss floor that steps 20 dB at 0.4 Hz: about -115 and -95 dB in that
    band, inside the default clip range."""
    n = int(seconds * sr)
    t = np.arange(n) / sr
    speed = (1.0 + 0.008 * np.sin(2 * np.pi * 0.55 * t)
             + 0.0015 * np.sin(2 * np.pi * 6.3 * t + 1.0))
    amp = np.where(np.sin(2 * np.pi * 0.4 * t) > 0, 3e-5, 3e-6)
    hiss = amp * np.random.default_rng(seed).standard_normal(n)
    mono = (0.003 * np.sin(2 * np.pi * F0 * np.cumsum(speed) / sr) + hiss).astype(np.float32)
    return np.stack([mono, mono * 0.8], -1)


def expand_phase(dev, smi):
    """Phase 17: ``expand`` at the defaults and with ``--transition 8000`` on
    the 30 s take with a stepped hiss floor: the quiet-hiss sections raised
    20 dB against the loud ones (to_fac of the band levels' difference);
    ``--stream`` within 2e-4 of in memory in the interior
    (tests/test_streaming_tools.py:199)."""
    from pyaudiorestoration_tpu_torch.utils import audio_io

    take = hiss_take(SR, SECONDS)
    res, errs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "hiss.wav")
        wavfile.write(src, SR, take)
        for name, extra in (("defaults", []), ("transition", ["--transition", "8000"])):
            argv = ["expand", src, "--device", str(dev), *extra]
            res[name] = tool_walls(f"expand {' '.join(extra) or '(defaults)'}", argv, smi)
            out = audio_io.read_file(os.path.join(tmp, "hiss_decompressed.wav"))[0]
            t0 = time.perf_counter()
            run_cli(argv + ["--stream", "--suffix", "_str"])
            res[name]["stream_s"] = time.perf_counter() - t0
            streamed = audio_io.read_file(os.path.join(tmp, "hiss_str.wav"))[0]
            errs[name] = interior_err(out, streamed, 4096)
            require(np.all(np.isfinite(out)) and out.shape == take.shape,
                    f"expand {name}: output {out.shape}")
            if name == "defaults":
                lift = 20 * math.log10(rms(out[:, 0], SR, 1.5, 2.3) / rms(out[:, 0], SR, 0.2, 1.0))
    print(f"expand: quiet-hiss sections raised {lift:.2f} dB against the loud ones "
          f"(want 20 +- 2); --stream vs in memory interior max|d| defaults "
          f"{errs['defaults']:.2e}, --transition 8000 {errs['transition']:.2e} (tol 2e-4); "
          f"--stream {res['defaults']['stream_s']:.3f} / {res['transition']['stream_s']:.3f} s")
    require(abs(lift - 20.0) <= 2.0, f"expand: gain step {lift} dB")
    require(max(errs.values()) <= 2e-4, f"expand --stream disagrees: {errs}")
    return {k: {**v, "stream_err": errs[k]} for k, v in res.items()}


def hpss_phase(take, dev, smi):
    """Phase 18: ``hpss`` at the defaults (fft 2048/4, kernel 31) on the take
    plus clicks every 0.25 s, and ``--margin 2`` (which writes ``_R``): H + P
    equals the input within 1e-3 in the interior, the tone goes to H and
    the clicks to P; ``--stream`` within 1e-5 of in memory in the interior;
    the median filter's own device time on the take's spectrogram."""
    from pyaudiorestoration_tpu_torch.ops import decompose, fourier
    from pyaudiorestoration_tpu_torch.utils import audio_io

    x = take.copy()
    clicks = np.arange(SR // 4, len(x) - 1, SR // 4)
    x[clicks] += 0.8
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "mix.wav")
        wavfile.write(src, SR, x)
        argv = ["hpss", src, "--device", str(dev)]
        res = tool_walls("hpss (defaults)", argv, smi)
        H, P = (audio_io.read_file(os.path.join(tmp, f"mix_{c}.wav"))[0] for c in "HP")
        t0 = time.perf_counter()
        run_cli(argv + ["--stream", "--suffix", "_str"])
        res["stream_s"] = time.perf_counter() - t0
        err_s = max(interior_err(a, audio_io.read_file(os.path.join(tmp, f"mix_{c}_str.wav"))[0],
                                 8192) for c, a in zip("HP", (H, P)))
        t0 = time.perf_counter()
        paths = run_cli(argv + ["--margin", "2", "--suffix", "_m2"])["outputs"]
        res["margin2_s"] = time.perf_counter() - t0
        R = audio_io.read_file(paths[2])[0]
    err_sum = interior_err(H + P, x, 8192)
    corr = float(np.corrcoef(H[SR:-SR, 0], take[SR:-SR, 0])[0, 1])
    p_clicks, h_clicks = np.abs(P[clicks[4:-4], 0]).mean(), np.abs(H[clicks[4:-4], 0]).mean()
    spec = torch.abs(fourier.stft(torch.as_tensor(np.ascontiguousarray(x.T), device=dev),
                                  2048, 512))
    harm_ms = cuda_ms(lambda: decompose.median_filter_1d(spec, 31, axis=-1), 3)
    perc_ms = cuda_ms(lambda: decompose.median_filter_1d(spec, 31, axis=-2), 3)
    print(f"hpss: H + P vs input interior max|d| {err_sum:.2e} (tol 1e-3); corr(H, tone) "
          f"{corr:.4f}; |P| / |H| at the clicks {p_clicks:.3f} / {h_clicks:.3f}; --stream "
          f"{res['stream_s']:.3f} s, vs in memory interior max|d| {err_s:.2e} (tol 1e-5); "
          f"--margin 2 {res['margin2_s']:.3f} s, _R {R.shape}; median filter on the "
          f"{tuple(spec.shape)} spectrogram: along time {harm_ms:.3f} ms, along frequency "
          f"{perc_ms:.3f} ms (kernel 31)")
    require(err_sum <= 1e-3 and corr > 0.8 and p_clicks > h_clicks,
            f"hpss: H+P {err_sum}, corr {corr}, clicks {p_clicks} / {h_clicks}")
    require(err_s <= 1e-5, f"hpss --stream disagrees with in memory: {err_s}")
    require(R.shape == x.shape and np.all(np.isfinite(R)), f"hpss --margin 2: R {R.shape}")
    return {**res, "stream_err": err_s, "median_time_ms": harm_ms, "median_freq_ms": perc_ms}


RN_NOISE_SR = 176_400  # resample ratio 0.919 to the take: K1's banded branch


def renoise_phase(take, dev, smi):
    """Phase 19: ``renoise --selection`` on the take, ``--stream`` within 1e-6
    of it in the interior; ``--noise`` from a 10 s noise file at 176.4 kHz,
    resampled to the take's rate by ``resample_ratio`` on K1's grid entry
    (one launch), and K1 there against its plain version; a 48 kHz noise
    file (ratio 4: the gather branch, no K1); ``sniff_offset``'s time."""
    from pyaudiorestoration_tpu_torch.ops import resampling as rs
    from pyaudiorestoration_tpu_torch.pipelines import renoiser
    from pyaudiorestoration_tpu_torch.utils import audio_io

    rng = np.random.default_rng(19)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "take.wav")
        wavfile.write(src, SR, take)
        argv = ["renoise", src, "--selection", "0.5", "1.5", "--device", str(dev)]
        res["selection"] = tool_walls("renoise --selection 0.5 1.5", argv, smi)
        out = audio_io.read_file(os.path.join(tmp, "take fft=1024.wav"))[0]
        t0 = time.perf_counter()
        run_cli(argv + ["--stream", "--suffix", "_str"])
        res["selection"]["stream_s"] = time.perf_counter() - t0
        err_s = interior_err(out, audio_io.read_file(os.path.join(tmp, "take_str.wav"))[0],
                             1024)
        noises = {}
        for sr_n in (RN_NOISE_SR, 48000):
            noises[sr_n] = (0.01 * rng.standard_normal((10 * sr_n, 2))).astype(np.float32)
            path = os.path.join(tmp, f"noise{sr_n}.wav")
            wavfile.write(path, sr_n, noises[sr_n])
            res[f"noise_{sr_n}"] = tool_walls(
                f"renoise --noise ({sr_n} Hz noise file)",
                ["renoise", src, "--noise", path, "--suffix", f"_n{sr_n}", "--device",
                 str(dev)], smi)
            out_n = audio_io.read_file(os.path.join(tmp, f"take_n{sr_n}.wav"))[0]
            require(out_n.shape == take.shape and np.all(np.isfinite(out_n)),
                    f"renoise --noise {sr_n}: output {out_n.shape}")
    k1_runs = res[f"noise_{RN_NOISE_SR}"]["k1_launches"]
    ratio = RN_NOISE_SR / SR
    pos = np.arange(int(round(10 * RN_NOISE_SR / ratio))) * ratio
    sig = torch.as_tensor(noises[RN_NOISE_SR][None, :, 0].copy(), device=dev)
    k1 = k1_grid_check(sig, pos, "renoise --noise's resample_ratio", nt=16)
    sniff = []
    for _ in range(3):
        t0 = time.perf_counter()
        offset = renoiser.sniff_offset(take, SR, 1024, 4, device=dev)
        torch.cuda.synchronize()
        sniff.append(time.perf_counter() - t0)
    sniff_s = statistics.median(sniff)
    gather = rs.banded_layout(np.arange(10) * 0.25, np.ones(10, np.float32)) is not None
    print(f"renoise: --stream vs in memory interior max|d| {err_s:.2e} (tol 1e-6); K1 "
          f"launches with the {RN_NOISE_SR} Hz noise {k1_runs} (want 1), with the 48 kHz "
          f"noise {res['noise_48000']['k1_launches']} (ratio 0.25: banded {gather}); "
          f"sniff_offset on the take {sniff_s * 1e3:.3f} ms (runs "
          f"{', '.join(f'{s * 1e3:.3f}' for s in sniff)}), offset {offset}")
    require(err_s <= 1e-6, f"renoise --stream disagrees with in memory: {err_s}")
    require(k1_runs == 1, f"renoise --noise: K1 launches {k1_runs}, want 1")
    return {**res, "stream_err": err_s, "sniff_offset_s": sniff_s}, k1


HUM = (50.75, 101.5, 152.25)  # 50 Hz mains and harmonics, the take 1.5 % fast


def zero_cross_hz(x, sr):
    """Mean frequency of a tone from its sub-sample zero crossings."""
    x = np.asarray(x, np.float64)
    idx = np.where(np.bitwise_xor(x[1:] > 0, x[:-1] > 0))[0]
    cr = idx + x[idx] / (x[idx] - x[idx + 1])
    return sr / np.mean(np.diff(cr[len(cr) // 4: -len(cr) // 4])) / 2


def humspeed_phase(take, dev, smi):
    """Phase 20: ``humspeed`` on the take with mains hum at 50.75, 101.5 and
    152.25 Hz (1.5 % fast): the ratio within 1e-3 of 50/50.75; the in-memory
    resample through ``resample_ratio`` (K1's grid entry, one launch a
    channel), and K1 there against its plain version; ``--stream`` (the
    constant curve through the streamed tier, K1's plan entry) at the same
    pitch and within 5e-3 of in memory after xcorr alignment
    (tests/test_streaming_tools.py:354-390), and K1's plan entry at that
    plan against its plain version."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
    from pyaudiorestoration_tpu_torch.utils import audio_io
    from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch

    t = np.arange(len(take)) / SR
    x = take + sum(0.05 * np.sin(2 * np.pi * f * t) for f in HUM)[:, None].astype(np.float32)
    want = 50 / HUM[0]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "hum.wav")
        wavfile.write(src, SR, x)
        argv = ["humspeed", src, "--device", str(dev)]
        res = tool_walls("humspeed (in-memory resample)", argv, smi)
        got = run_cli(argv)
        ratio = got["matches"][-1]["ratio"]
        a = audio_io.read_file(got["outputs"][0])[0]
        reset_launches(kb)
        t0 = time.perf_counter()
        out_s = run_cli(argv + ["--stream"])["outputs"][0]
        torch.cuda.synchronize()
        res["stream_s"] = time.perf_counter() - t0
        res["k1_stream_launches"] = launches(kb)[0]
        b = audio_io.read_file(out_s)[0]
    pitch = [zero_cross_hz(y[:, 0], SR) for y in (a, b)]
    h = 8192
    m = min(len(a), len(b)) - h
    xa, xb = a[h:m, 0], b[h:m, 0]
    k = int(np.argmax([np.dot(xa[64:4096], xb[64 + k:4096 + k])
                       for k in range(-64, 65)])) - 64
    err = float(np.abs(xa[64:20000] - xb[64 + k:20000 + k]).max())
    print(f"humspeed: matches {[round(mt['freq'], 4) for mt in got['matches']]} Hz, ratio "
          f"{ratio:.6f} (want {want:.6f}, tol 1e-3); K1 launches in memory "
          f"{res['k1_launches']} (one a channel), --stream {res['k1_stream_launches']} "
          f"({res['stream_s']:.3f} s); pitch in memory / streamed {pitch[0]:.4f} / "
          f"{pitch[1]:.4f} Hz; streamed vs in memory after alignment ({k} samples) max|d| "
          f"{err:.2e} (tol 5e-3); lengths {len(a)} / {len(b)}")
    require(abs(ratio - want) <= 1e-3, f"humspeed ratio {ratio}, want {want}")
    require(res["k1_launches"] == 2 and res["k1_stream_launches"] == 1,
            f"humspeed: K1 launches {res['k1_launches']} / {res['k1_stream_launches']} "
            f"(want 2 / 1: one a channel; one tile)")
    require(abs(pitch[0] - pitch[1]) <= 1e-4 * pitch[0] and err <= 5e-3
            and abs(len(a) - len(b)) < 1024, f"humspeed --stream: pitch {pitch}, err {err}")
    sig = torch.as_tensor(np.ascontiguousarray(x.T), device=dev)
    n_out = int(round(len(x) / ratio))
    k1_grid = k1_grid_check(sig, np.arange(n_out, dtype=np.float64) * ratio,
                            "humspeed's resample_ratio", nt=16)
    hop = 4096 // 8
    speeds = np.full((len(x) + 2 * 2048 - 4096) // hop + 1, 1.0 / ratio)
    plan = rt.plan_positions_fast(speeds, hop, len(x))
    p = plan_to_torch(plan, dev)
    k1_plan = check_plan_kernel(
        "K1", sig, (torch.as_tensor(speeds.astype(np.float32), device=dev), p["n"],
                    p["base_int"], p["base_frac"]), p["max_n"], QUALITY,
        rt._drift_bucket(p["drift"]), seed=20)
    return {**res, "ratio": ratio, "stream_err": err}, k1_grid, k1_plan


def pan_phase(take, dev, smi):
    """Phase 21: ``pan`` with a two-sample ``.pan`` project (each box's L/R
    ratio measured by ``measure_pan``, 1.25 on the take); ``pan_file``
    streamed within 1e-7 of in memory."""
    from pyaudiorestoration_tpu_torch.pipelines import pan
    from pyaudiorestoration_tpu_torch.utils import audio_io, project

    boxes = [((f0 * SECONDS, 200.0), (f1 * SECONDS, 8000.0)) for f0, f1 in ((0.15, 0.35),
                                                                          (0.65, 0.85))]
    samples = [pan.measure_pan(take, SR, a, b, device=dev) for a, b in boxes]
    with tempfile.TemporaryDirectory() as tmp:
        src, proj = os.path.join(tmp, "take.wav"), os.path.join(tmp, "take.pan")
        wavfile.write(src, SR, take)
        project.Project(".pan", {"fft_size": 1024, "fft_overlap": 4},
                        {"markers": samples}).save(proj)
        res = tool_walls("pan (.pan project, 2 samples)", ["pan", src, "--project", proj,
                                                           "--device", str(dev)], smi)
        out = audio_io.read_file(os.path.join(tmp, "take_out.wav"))[0]
        t0 = time.perf_counter()
        streamed = audio_io.read_file(pan.pan_file(src, samples, stream=True, device=dev))[0]
        res["stream_s"] = time.perf_counter() - t0
    err = float(np.abs(out - streamed).max()) if out.shape == streamed.shape else math.inf
    lr = float(np.abs(out[:, 0] - take[:, 0]).max())
    print(f"pan: measured {[round(s.pan, 5) for s in samples]} (want 1.25); streamed vs "
          f"in memory max|d| {err:.2e} (tol 1e-7), --stream {res['stream_s']:.3f} s; "
          f"output (channel 1 x pan) vs channel 0 max|d| {lr:.2e} (tol 1e-3)")
    require(all(abs(s.pan - 1.25) < 0.01 for s in samples), "pan: measured ratios")
    require(err <= 1e-7 and lr < 1e-3, f"pan: streamed {err}, vs channel 0 {lr}")
    return {**res, "stream_err": err}


def envelope_db(x, sr, win=0.1):
    """Channel 0's RMS in ``win``-second windows, in dB."""
    w = int(win * sr)
    seg = x[: len(x) // w * w, 0].astype(np.float64).reshape(-1, w)
    return 10 * np.log10(np.mean(seg * seg, axis=1) + 1e-20)


def decompress_phase(take, dev, smi):
    """Phase 22: ``decompress`` with and without ``--sync`` on the take under
    a smooth random envelope (reference) and the same compressed to its
    0.3 power (source): the output's level follows the reference's
    (envelope correlation over 0.9) and swings at least 6 dB wider than the
    source's (the gain is clipped to [0, 2]); ``--stream`` within 5e-4 of in
    memory in the interior (tests/test_streaming_tools.py:351)."""
    from scipy.ndimage import uniform_filter1d

    from pyaudiorestoration_tpu_torch.utils import audio_io

    n = len(take)
    w = SR // 5
    env = np.exp(1.5 * uniform_filter1d(np.random.default_rng(22).standard_normal(n), w,
                                        mode="wrap") * math.sqrt(w))
    env = (env / env.max())[:, None]
    ref_sig = (take * env).astype(np.float32)
    src_sig = (take * 0.6 * env ** 0.3).astype(np.float32)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        src, ref = os.path.join(tmp, "src.wav"), os.path.join(tmp, "ref.wav")
        wavfile.write(src, SR, src_sig)
        wavfile.write(ref, SR, ref_sig)
        for name, extra in (("plain", []), ("sync", ["--sync"])):
            argv = ["decompress", src, ref, "--device", str(dev), *extra]
            res[name] = tool_walls(f"decompress {' '.join(extra)}".strip(), argv, smi)
            out = audio_io.read_file(os.path.join(tmp, "src_decompressed.wav"))[0]
            t0 = time.perf_counter()
            run_cli(argv + ["--stream"])
            res[name]["stream_s"] = time.perf_counter() - t0
            streamed = audio_io.read_file(os.path.join(tmp, "src_decompressed.wav"))[0]
            res[name]["stream_err"] = interior_err(out, streamed, SR // 2)
            e_out, e_ref, e_src = (envelope_db(y, SR) for y in (out, ref_sig, src_sig))
            res[name]["env_corr"] = float(np.corrcoef(e_out[10:-10], e_ref[10:-10])[0, 1])
            res[name]["swing_db"] = [float(np.ptp(e[10:-10])) for e in (e_src, e_out, e_ref)]
    print("decompress: " + "; ".join(
        f"{k}: --stream {v['stream_s']:.3f} s, vs in memory interior max|d| "
        f"{v['stream_err']:.2e} (tol 5e-4), level swing source / output / reference "
        f"{v['swing_db'][0]:.1f} / {v['swing_db'][1]:.1f} / {v['swing_db'][2]:.1f} dB, "
        f"envelope corr with the reference {v['env_corr']:.4f}" for k, v in res.items()))
    for k, v in res.items():
        require(v["stream_err"] <= 5e-4, f"decompress {k} --stream: {v['stream_err']}")
        require(v["env_corr"] > 0.9 and v["swing_db"][1] > v["swing_db"][0] + 6,
                f"decompress {k}: corr {v['env_corr']}, swings {v['swing_db']}")
    return res


GD_SR, GD_SECONDS, GD_DELAY = 44100, 60.0, 21  # group-delay's pair


def group_delay_phase(dev, smi):
    """Phase 23: ``group-delay`` at its defaults on a 60 s 44.1 kHz noise pair,
    the source 21 samples late: the median band lag within 1 sample of -21
    (the source's lateness reads as a negative lag, tests/test_aux.py:163)."""
    from scipy import signal as dsp

    n = int(GD_SECONDS * GD_SR)
    rng = np.random.default_rng(23)
    sos = dsp.butter(2, [20 / (GD_SR / 2), 3000 / (GD_SR / 2)], btype="band", output="sos")
    ref_sig = (0.3 * dsp.sosfilt(sos, rng.standard_normal((n + GD_DELAY, 2)), axis=0)
               ).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        ref, src = os.path.join(tmp, "ref.wav"), os.path.join(tmp, "src.wav")
        wavfile.write(ref, GD_SR, ref_sig[GD_DELAY:])
        wavfile.write(src, GD_SR, ref_sig[:n])
        argv = ["group-delay", ref, src, "--device", str(dev)]
        res = tool_walls("group-delay (60 s 44.1 kHz pair)", argv, smi, seconds=GD_SECONDS)
        bands = run_cli(argv)["bands"]
    lags = np.array([b["lag_samples"] for b in bands])
    med = float(np.median(lags)) if len(lags) else math.nan
    print(f"group-delay: {len(bands)} bands over min_corr, median lag {med:.4f} samples "
          f"(want {-GD_DELAY} +- 1), lags {lags.min():.3f} .. {lags.max():.3f}")
    require(len(bands) >= 10 and abs(med + GD_DELAY) <= 1.0,
            f"group-delay: {len(bands)} bands, median lag {med}")
    return {**res, "median_lag": med, "bands": len(bands)}


CW_SR, CW_SECONDS, CW_RPM = 44100, 60.0, 44.0  # cyclic-wow's record transfer


def cyclic_wow_phase(dev, smi):
    """Phase 24: ``cyclic-wow`` at its defaults (nominal 45 rpm, fft 16384)
    on a 60 s 44.1 kHz transfer of a 44 rpm record: a 700 Hz tone with 1 %
    wow at the rotation rate; ``actual_rpm`` within 2 % of 44."""
    n = int(CW_SECONDS * CW_SR)
    t = np.arange(n) / CW_SR
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * CW_RPM / 60 * t)
    tone = (0.5 * np.sin(2 * np.pi * 700 * np.cumsum(speed) / CW_SR)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "record.wav")
        wavfile.write(src, CW_SR, np.stack([tone, tone], -1))
        argv = ["cyclic-wow", src, "--device", str(dev)]
        res = tool_walls("cyclic-wow (60 s 44.1 kHz, 44 rpm)", argv, smi, seconds=CW_SECONDS)
        got = run_cli(argv)
    print(f"cyclic-wow: actual_rpm {got['actual_rpm']:.4f} (want {CW_RPM} +- 2 %), cycle "
          f"{got['cycle_duration_s']:.4f} s, wow depth {got['wow_depth_semitones']:.4f} st")
    require(abs(got["actual_rpm"] - CW_RPM) <= 0.02 * CW_RPM,
            f"cyclic-wow: {got['actual_rpm']} rpm")
    return {**res, "actual_rpm": got["actual_rpm"]}


# ---------------------------------------------------------------------------
# Phases 25-30: the user-facing surface (view, listen, measure, the compare
# page, doctor)
# ---------------------------------------------------------------------------

VIEW_FFT, VIEW_HOP = 1024, 256  # view's defaults (fft 1024, overlap 4)
STEP_SHARE = 1e-4  # card vs CPU render: share of pixels one table step apart


def page_parts(path):
    """(meta, markers, decoded (h, w, 3) uint8 image) of a viewer page."""
    import base64
    import re
    import zlib

    page = open(path, encoding="utf-8").read()
    meta = json.loads(re.search(r"const META = (\{.*?\});", page).group(1))
    markers = json.loads(re.search(r"const MARKERS = (\[.*?\]);", page).group(1))
    png = base64.b64decode(re.search(r'base64,([A-Za-z0-9+/=]+)"', page).group(1))
    w, h = struct.unpack(">II", png[16:24])
    i = png.index(b"IDAT") + 4
    n = struct.unpack(">I", png[i - 8:i - 4])[0]
    raw = np.frombuffer(zlib.decompress(png[i:i + n]), np.uint8).reshape(h, 1 + 3 * w)
    return meta, markers, raw[:, 1:].reshape(h, w, 3)


def table_steps(a, b, table):
    """Share of pixels where a and b differ, and the largest table-index
    distance between them (the two colors' nearest entries)."""
    diff = np.any(a != b, -1)
    index = {}
    for i, c in enumerate(map(tuple, table)):
        index.setdefault(c, []).append(i)
    worst = 0
    for pa, pb in zip(a[diff], b[diff]):
        worst = max(worst, min(abs(i - j) for i in index[tuple(pa)]
                               for j in index[tuple(pb)]))
    return float(diff.mean()), worst


def pilot_hz(t):
    """wow_take's pilot frequency at times ``t``."""
    return F0 * (1.0 + 0.008 * np.sin(2 * np.pi * 0.55 * t)
                 + 0.0015 * np.sin(2 * np.pi * 6.3 * t + 1.0))


def view_phase(take, dev, smi):
    """Phases 25-26: ``view`` at its defaults (fft 1024, overlap 4, izo) with
    ``--trail`` on the pilot of the 30 s take, cold and warm: the image is
    513 x 22,501 and the traced curve within 1 % of the pilot's frequency;
    then ``render_rgb`` on the card against the port's CPU render of the same
    magnitude (at most 1e-4 of pixels, one table step), the card's render
    time beside the CPU's and the bytes it downloads."""
    from pyaudiorestoration_tpu_torch.models import viz_html
    from pyaudiorestoration_tpu_torch.ops import fourier

    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "take.wav"), os.path.join(tmp, "take.html")
        wavfile.write(src, SR, take)
        argv = ["view", src, "--trail", "0.5", str(F0), str(SECONDS - 0.5), str(F0), "-o",
                out, "--device", str(dev)]
        res = tool_walls("view --trail (30 s 192 kHz stereo, fft 1024/4)", argv, smi)
        meta, markers, rgb = page_parts(out)
        page_mb = os.path.getsize(out) / 1e6
    n_frames = take.shape[0] // VIEW_HOP + 1
    t, f = np.asarray(markers[0]["t"]), np.asarray(markers[0]["f"])
    trail_err = float(np.max(np.abs(f / pilot_hz(t) - 1)))
    print(f"view: image {rgb.shape} ({rgb.nbytes / 1e6:.1f} MB), page {page_mb:.1f} MB, "
          f"traced {len(t)} frames, worst |f / pilot - 1| {trail_err:.5f} (tol 0.01)")
    require(rgb.shape == (VIEW_FFT // 2 + 1, n_frames, 3) and meta["w"] == n_frames
            and meta["h"] == VIEW_FFT // 2 + 1, f"view: image {rgb.shape}, meta {meta}")
    require(len(t) > 0.9 * (SECONDS - 1) * SR / VIEW_HOP and trail_err <= 0.01,
            f"view --trail: {len(t)} frames, worst relative error {trail_err}")

    # 26. the card's render against the CPU's on the same magnitude
    mag = fourier.get_mag(torch.as_tensor(take[:, 0].copy(), device=dev), VIEW_FFT,
                          VIEW_HOP)
    mag_cpu = mag.cpu()
    card, _ = viz_html.render_rgb(mag, SR, VIEW_HOP, device=dev)
    cpu, _ = viz_html.render_rgb(mag_cpu, SR, VIEW_HOP, device="cpu")
    share, worst = table_steps(card, cpu, viz_html.cmap_table("izo"))
    table = torch.as_tensor(viz_html.cmap_table("izo"), device=dev)
    rows = viz_html.mel_rows(mag.shape[0], SR, mag.shape[0], 20.0)

    def device_render():
        norm = viz_html.norm_rows(mag, rows, -120, 0)
        return table[torch.clamp((norm * 256).to(torch.int64), max=255)]

    dev_ms = cuda_ms(device_render, 5)
    card_s, _ = wall_s(lambda: viz_html.render_rgb(mag, SR, VIEW_HOP, device=dev), 3)
    t0 = time.perf_counter()
    viz_html.render_rgb(mag_cpu, SR, VIEW_HOP, device="cpu")
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    viz_html._png_b64(card)
    png_s = time.perf_counter() - t0
    print(f"[{smi}] render_rgb, card vs the port's CPU render of the card's magnitude "
          f"{tuple(mag.shape)}: {share:.2e} of pixels differ (tol {STEP_SHARE:.0e}), worst "
          f"{worst} table step(s); device render {dev_ms:.3f} ms, render + download "
          f"{card_s * 1e3:.3f} ms ({card.nbytes / 1e6:.1f} MB uint8 against "
          f"{mag.numel() * 4 / 1e6:.1f} MB float32), CPU render {cpu_s * 1e3:.1f} ms; "
          f"PNG deflate + base64 on the host {png_s * 1e3:.1f} ms")
    require(share <= STEP_SHARE and worst <= 1,
            f"render_rgb card vs CPU: {share} of pixels differ, worst {worst} steps")
    return {**res, "trail_rel_err": trail_err, "render_share_differ": share,
            "render_device_ms": dev_ms, "render_download_s": card_s, "render_cpu_s": cpu_s,
            "png_b64_s": png_s}


def listen_measure_phase(take, dev, smi):
    """Phases 27-28: ``respeed --fast`` of the take, then ``listen`` of the
    take and its output (two 30 s lanes: the WAVs are 16-bit copies, the
    strips 160 rows), cold and warm; ``measure`` of the pair and of the
    output: flutter before and after (under 0.2x, as phase 4 asks), SNR and
    the spectral distance, that within 1e-3 dB of the CPU's."""
    import base64

    from pyaudiorestoration_tpu_torch.utils import audio_io, metrics

    with tempfile.TemporaryDirectory() as tmp:
        src, page = os.path.join(tmp, "take.wav"), os.path.join(tmp, "aud.html")
        wavfile.write(src, SR, take)
        res_path = run_cli(["respeed", src, "--fast", "--device", str(dev), "--fft-size",
                            str(FFT), "--fft-overlap", str(OVERLAP), "--zeropad",
                            str(ZEROPAD), "--sinc-quality", str(QUALITY)])["outputs"][0]
        listen = tool_walls("listen (take and its respeed --fast output)",
                            ["listen", src, res_path, "-o", page, "--device", str(dev)], smi)
        html = open(page, encoding="utf-8").read()
        wavs = [base64.b64decode(p.split('"')[0]) for p in html.split("audio/wav;base64,")[1:]]
        n_out = audio_io.read_file(res_path)[0].shape[0]
        meas_argv = ["measure", src, res_path, "--device", str(dev)]
        measure = tool_walls("measure (the pair: flutter, SNR, spectral distance)",
                             meas_argv, smi)
        pair = run_cli(meas_argv)
        after = run_cli(["measure", res_path, "--device", str(dev)])["flutter"]
        restored = audio_io.read_file(res_path)[0]
        t0 = time.perf_counter()
        cpu_dist = metrics.spectral_distance_db(take, restored, SR, device="cpu")
        cpu_s = time.perf_counter() - t0
    want = [44 + 2 * 2 * n for n in (take.shape[0], n_out)]
    print(f"listen: page {len(html) / 1e6:.1f} MB, WAV payloads {[len(w) for w in wavs]} "
          f"bytes (want {want})")
    print(f"measure: flutter {pair['flutter']} -> {after}, SNR {pair['snr_db']} dB, spectral "
          f"distance {pair['spectral_distance_db']} dB (CPU {cpu_dist:.4f} dB in "
          f"{cpu_s:.3f} s)")
    require([len(w) for w in wavs] == want and html.count("image/png;base64,") == 2,
            f"listen: WAV payloads {[len(w) for w in wavs]}, want {want}")
    require(after < 0.2 * pair["flutter"], f"measure: flutter {pair['flutter']} -> {after}")
    # measure rounds to 1e-3 dB: the card within 1e-3 of the CPU, plus half a step
    require(pair["snr_db"] is not None and abs(pair["spectral_distance_db"] - cpu_dist)
            <= 1.5e-3, f"measure: {pair}, CPU spectral distance {cpu_dist}")
    return ({**listen, "page_mb": len(html) / 1e6},
            {**measure, "flutter_before": pair["flutter"], "flutter_after": after,
             "snr_db": pair["snr_db"], "spectral_distance_db": pair["spectral_distance_db"]})


def compare_phase(dev, smi, tape, mpl):
    """Phase 29: ``tapesync --compare out.html`` on phase 15's pair, cold and
    warm: K1's launches as in phase 15; the overlay's red (the reference)
    and green (the aligned output) channels correlate above 0.99; with
    matplotlib, ``--compare out.png`` too."""
    ref, src_sig = tapesync_pair(TS_SR, TS_SECONDS)
    with tempfile.TemporaryDirectory() as tmp:
        r, s = os.path.join(tmp, "ref.wav"), os.path.join(tmp, "src.wav")
        out = os.path.join(tmp, "cmp.html")
        wavfile.write(r, TS_SR, ref)
        wavfile.write(s, TS_SR, src_sig)
        res = tool_walls("tapesync --compare out.html (60 s 44.1 kHz pair)",
                         ["tapesync", r, s, "--compare", out, "--device", str(dev)], smi,
                         seconds=TS_SECONDS)
        meta, _, rgb = page_parts(out)
        if mpl:
            png = os.path.join(tmp, "cmp.png")
            run_cli(["tapesync", r, s, "--compare", png, "--device", str(dev)])
            require(os.path.getsize(png) > 1000, "tapesync --compare x.png wrote no image")
    corr = float(np.corrcoef(rgb[..., 0].ravel().astype(np.float64),
                             rgb[..., 1].ravel().astype(np.float64))[0, 1])
    want = tape["k1 resample_ratio"] + tape["k1 run"]
    print(f"tapesync --compare: image {rgb.shape}, red/green correlation {corr:.5f} "
          f"(want > 0.99); K1 launches {res['k1_launches']} (phase 15: {want})"
          + ("; --compare x.png written" if mpl else ""))
    require(rgb.shape == (VIEW_FFT // 2 + 1, meta["w"], 3) and corr > 0.99,
            f"tapesync --compare: image {rgb.shape}, correlation {corr}")
    require(res["k1_launches"] == want,
            f"tapesync --compare: K1 launches {res['k1_launches']}, phase 15 {want}")
    return {**res, "red_green_corr": corr}


def doctor_phase(smi):
    """Phase 30: ``doctor`` on the card: healthy (exit 0), with its probe's
    K1 launch (in the child process) within 3e-5 of the plain version."""
    from pyaudiorestoration_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["doctor"])
    wall = time.perf_counter() - t0
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    d = rep.get("device", {})
    print(f"[{smi}] doctor: healthy {rep['healthy']} in {wall:.2f} s; codec "
          f"{rep['native_codec']}; kernels {rep['kernels']}; device probe {d}")
    require(rc == 0 and rep["healthy"] and d.get("status") == "ok" and d.get("k1_launches") == 1
            and d.get("k1_max_abs_err", 1.0) <= TOL, f"doctor: {rep}")
    return {"wall_s": wall, "k1_launches": d["k1_launches"],
            "k1_max_abs_err": d["k1_max_abs_err"]}


def matplotlib_forms(take, dev, mpl):
    """The PNG figures where ``import matplotlib`` succeeds (``mpl``):
    ``viz``'s spectrogram of the take and ``renoise --preview``
    (``tapesync --compare x.png`` runs in phase 29).  Returns the forms run."""
    if not mpl:
        print("matplotlib is absent: the PNG forms (viz figures, tapesync --compare x.png, "
              "renoise --preview) did not run")
        return []
    from pyaudiorestoration_tpu_torch.models import viz
    from pyaudiorestoration_tpu_torch.ops import fourier

    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "take.wav")
        wavfile.write(src, SR, take)
        mag = fourier.get_mag(torch.as_tensor(take[:, 0].copy(), device=dev), VIEW_FFT,
                              VIEW_HOP)
        fig = viz.save_spectrogram(os.path.join(tmp, "s.png"), mag, SR, VIEW_HOP)
        preview = run_cli(["renoise", src, "--selection", "0.5", "1.5", "--preview",
                           os.path.join(tmp, "p.png"), "--device", str(dev)])["preview"]
        sizes = [os.path.getsize(p) for p in (fig, preview)]
    require(min(sizes) > 1000, f"matplotlib figures of {sizes} bytes")
    forms = ["viz.save_spectrogram", "tapesync --compare x.png", "renoise --preview"]
    print(f"matplotlib forms run: {', '.join(forms)}")
    return forms


# ---------------------------------------------------------------------------
# Phases 31-34: the mesh tier (parallel/) over torch.distributed ranks
# ---------------------------------------------------------------------------

MESH_SHAPES = ((1, 4), (2, 2))  # the four-rank meshes, ranks sharing the card (gloo)
TOOL_FFT, TOOL_HOP = 4096, 1024


def rank_timer(dev):
    """``cuda_ms`` on a card, None on the CPU (a rehearsal times nothing)."""
    return cuda_ms if dev.type == "cuda" else (lambda fn, reps, inner=1: None)


def kernel_vs_plain(what, dev, entry, plain, args, taps, nbytes, rows, timed=True):
    """A kernel entry against its plain version on ``args``: max|d| (held to
    TOL) and, where ``timed``, both times, the bound and its share."""
    got, ref = entry(*args), plain(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= TOL:
        raise RuntimeError(f"{what}: the kernel disagrees with its plain version: {err}")
    rec = {"max_abs_err": err, "rows": rows, "taps": taps, "bytes": nbytes}
    if timed:
        t = rank_timer(dev)
        ms = [t(lambda: entry(*args), 10, inner=10)]
        plain_ms = t(lambda: plain(*args), 3)
        ms.append(t(lambda: entry(*args), 10, inner=10))
        bound_ms, bound_by = bound(taps, nbytes)
        ms = statistics.median(ms) if ms[0] is not None else None
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   share_of_bound=bound_ms / ms if ms else None, library_ms=None)
    return rec


def sync_wall(mesh, fn):
    """Seconds of ``fn()`` on the mesh: every rank starts together and the
    wall ends when the last rank's card is done."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    out = fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    mesh.barrier()
    return time.perf_counter() - t0, out


def mesh_batch(sr, seconds, n_time):
    """Phase 8's 8-take batch from the take's channel 0, rows padded to the
    time axis with the reflect continuation (``load_batch(reflect_tail=)``),
    with the takes' lengths, the band limits and the band."""
    from pyaudiorestoration_tpu_torch.parallel import batch as pb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    mono = wow_take(sr, seconds)[:, 0]
    hop, n = FFT // OVERLAP, len(mono)
    N = -(-(n + FFT) // (n_time * hop)) * (n_time * hop)
    xb = np.zeros((8, N), np.float32)
    for i in range(8):
        xb[i, :n] = mono * np.float32(0.5 + 0.06 * i)
        pb.reflect_continue(xb[i], n, FFT)
    NLv, NUv = rt._band_limits(rt._probe_f0(mono, sr), 1.0, FFT, ZEROPAD, sr)
    F = N // hop + 1
    return xb, [n] * 8, np.full(F, NLv, np.int32), np.full(F, NUv, np.int32), (NLv - 1,
                                                                              NUv + 1)


def fused_mesh_rank(dev, shapes, sr, seconds, timed=True):
    """One rank of phase 31: for each (files, time) mesh of ``shapes``,
    ``restore_fused_sharded`` on the 8-take batch with K1 ("pallas") and K2
    ("xla"), each kernel's launches on this rank, the walls, K1's and K2's
    plan entries against their plain versions at this rank's shard shape
    (timed on rank 0 while the others wait), the halo and carry exchanges;
    rank 0 also checks every gathered row against its solo run."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.parallel import mesh as pm
    from pyaudiorestoration_tpu_torch.parallel import sharded as ps
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    hop, out = FFT // OVERLAP, {}
    solos = None
    for nf, nt_ in shapes:
        mesh = pm.Mesh(nf, nt_, dev)
        xb, lengths, NL, NU, band = mesh_batch(sr, seconds, nt_)
        xs = pm.shard_time_batch(mesh, xb)
        kw = dict(band=band, lengths=lengths)
        rec = {"backend": mesh.backend, "rank_device": str(dev),
               "shard": list(xs.shape)}
        grids = {}
        for backend in ("pallas", "xla"):
            def run(backend=backend):
                return ps.restore_fused_sharded(mesh, xs, NL, NU, FFT, hop, ZEROPAD, MAX_N,
                                                QUALITY, DRIFT, backend=backend, **kw)
            reset_launches(kb)
            cold, res = sync_wall(mesh, run)
            rec[f"{backend}_launches"] = list(launches(kb))
            warm = [sync_wall(mesh, run)[0] for _ in range(3)]
            rec[f"{backend}_cold_s"], rec[f"{backend}_warm_s"] = cold, warm
            grids[backend] = res
        rec["k1_vs_k2"] = float((grids["pallas"][0] - grids["xla"][0]).abs().max())
        padded = pm.gather_time_batch(mesh, grids["pallas"][0])
        nn = pm.gather_time_batch(mesh, grids["pallas"][1])
        del grids
        # the kernels at this rank's shard shape
        p = ps.fused_sharded_plan(mesh, xs, NL, NU, FFT, hop, ZEROPAD, MAX_N, QUALITY,
                                  DRIFT, band=band, lengths=lengths)
        flat = rt._flatten_takes(p["ext"], p["speeds"], p["nn"], p["anchors"],
                                 p["base_frac"], MAX_N, QUALITY, DRIFT)
        sig_flat, s_lo, s_hi, nn_f, bi_f, bf_f = flat
        rows, outputs = int(nn_f.shape[0]), int(nn_f.sum())
        U = QUALITY + DRIFT
        buf = kb.gather_windows(sig_flat, bi_f, MAX_N + 2 * U, U)
        checks = (("k1_plan_entry", kb.sinc_banded_plan, kb.sinc_banded_plan_plain,
                   (sig_flat, bi_f, s_lo, s_hi, nn_f, bf_f, MAX_N, QUALITY, DRIFT),
                   sig_flat.numel() * 4 + rows * 4 * 5),
                  ("k2_plan_entry", kb.sinc_banded_gathered_plan,
                   kb.sinc_banded_gathered_plan_plain,
                   (buf, s_lo, s_hi, nn_f, bf_f, MAX_N, QUALITY, DRIFT),
                   buf.numel() * 4 + rows * 4 * 4))
        for name, entry, plain, args, in_bytes in checks:
            # every rank checks its shard; rank 0 times while the others wait
            rec[name] = kernel_vs_plain(f"{name} on the {nf}x{nt_} mesh", dev, entry,
                                        plain, args, outputs * 2 * QUALITY,
                                        in_bytes + rows * MAX_N * 4, rows,
                                        timed=timed and mesh.rank == 0)
            mesh.barrier()
        del buf, flat, p
        # the collectives alone: the tracking and sinc halos, the carry
        pad = FFT // 2
        halo = lambda: mesh.exchange("time", to_left=xs[..., :pad], to_right=xs[..., -pad:])
        carry = lambda: mesh.all_gather(torch.zeros((2, xs.shape[0]), dtype=torch.float64,
                                                    device=dev), "time")
        limbs = lambda: mesh.psum(torch.zeros((3, xs.shape[0]), device=dev), "time")
        for name, fn in (("halo_exchange", halo), ("carry_all_gather", carry),
                         ("limbs_psum", limbs)):
            fn()
            rec[f"{name}_ms"] = statistics.median(
                sync_wall(mesh, fn)[0] * 1e3 for _ in range(10))
        if mesh.rank == 0:
            if solos is None:  # the takes and their lengths are the same on every mesh
                Fs = lengths[0] // hop + 1
                solos = [rt.restore_fused_device(
                    xb[i, :lengths[0]], NL[:Fs], NU[:Fs], FFT, hop, ZEROPAD, MAX_N,
                    QUALITY, DRIFT, backend="pallas", band=band, device=dev).cpu().numpy()
                    for i in range(8)]
            T = solos[0].shape[0]
            rec["rows_bit_equal"] = [bool(np.array_equal(padded[i, :T], s))
                                     for i, s in enumerate(solos)]
            rec["rows_max_abs_diff"] = [float(np.abs(padded[i, :T] - s).max())
                                        for i, s in enumerate(solos)]
            rec["grid"] = list(padded.shape)
            rec["segments_counted"] = int(nn[:, :T].sum())
        out[f"{nf}x{nt_}"] = rec
    return out


def restore_step_rank(dev, paths, timed=True):
    """Phase 33's kernel half on a 1 x 4 mesh: ``restore_step`` with the
    windowed sinc on the three takes cut to one length (K2's grid entry,
    one launch a rank), its flutter, and the grid entry against its plain
    version at that shape.  The drift halo grows past its default 256 to
    the take's accumulated wow at 192 kHz (0.8 % at 0.55 Hz: +-444
    samples)."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.parallel import batch as pb
    from pyaudiorestoration_tpu_torch.parallel import mesh as pm
    from pyaudiorestoration_tpu_torch.parallel import sharded as ps

    hop, nt = FFT // OVERLAP, 16
    mesh = pm.Mesh(1, 4, dev)
    xb, sr, lengths = pb.load_batch(paths)
    L = min(lengths) // (4 * hop) * (4 * hop)
    xb, lengths = np.ascontiguousarray(xb[:, :L]), [L] * len(lengths)
    xs = pm.shard_time_batch(mesh, xb)
    kw = dict(n_fft=FFT, step=hop, interp="sinc", nt=nt)
    reset_launches(kb)
    wall, y = sync_wall(mesh, lambda: ps.restore_step(mesh, xs, F0, sr, **kw))
    rec = {"backend": mesh.backend, "launches": list(launches(kb)), "cold_s": wall,
           "warm_s": [sync_wall(mesh, lambda: ps.restore_step(mesh, xs, F0, sr, **kw))[0]
                      for _ in range(3)]}
    y = pm.gather_time_batch(mesh, y)
    rel, up = ps.step_positions(mesh, xs, F0, sr, FFT, hop)
    halo = ps.step_halo(mesh, rel, 256)
    buf, bs, rel_s, in_seg, seg_drift = ps.step_windows(mesh, xs, rel, up, hop, 2.0, halo,
                                                        nt)
    rows = int(bs.shape[0])
    rec["k2_grid_entry"] = kernel_vs_plain(
        "K2's grid entry at restore_step's sinc shape", dev, kb.sinc_banded_gathered,
        lambda *a: kb.sinc_shift_mac(a[0], *a[1:4], hop, a[4], a[5]),
        (buf, bs, rel_s, in_seg, nt, seg_drift), int(in_seg.sum()) * 2 * nt,
        buf.numel() * 4 + bs.numel() * 9 + bs.numel() * 4, rows,
        timed=timed and mesh.rank == 0)
    rec["k2_grid_entry"]["drift"] = seg_drift
    rec["drift_halo"] = halo
    mesh.barrier()
    if mesh.rank == 0:
        rec["flutter"] = [(tone_stability(xb[i, :L].astype(np.float64), sr),
                           tone_stability(y[i, :L].astype(np.float64), sr))
                          for i, L in enumerate(lengths)]
    return rec


def stereo_lag_rank(dev, take_path, f0, export, timed=True):
    """Phases 32 and 34's file halves in the four-rank world:
    ``restore_file_sharded`` on the stereo take (a 2 x 2 mesh, the channels
    on the files axis) and ``lag_resample_file_sharded`` on phase 15's
    ratio-corrected source and lag curve; each with K1's or K2's launches on
    this rank."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.parallel import batch as pb
    from pyaudiorestoration_tpu_torch.parallel import mesh as pm
    from pyaudiorestoration_tpu_torch.parallel import sharded as ps
    from pyaudiorestoration_tpu_torch.utils import audio_io

    rec = {}
    reset_launches(kb)
    t0 = time.perf_counter()
    out = pb.restore_file_sharded(take_path, f0_hz=f0, fft_size=FFT, fft_overlap=OVERLAP,
                                  zeropad=ZEROPAD, sinc_quality=QUALITY, drift=DRIFT,
                                  backend="pallas", device="cuda" if dev.type == "cuda"
                                  else "cpu")
    rec["file"] = {"output": out, "launches": list(launches(kb)),
                   "wall_s": time.perf_counter() - t0}
    src_path, st_s, lg_s = export
    reset_launches(kb)
    t0 = time.perf_counter()
    out = pb.lag_resample_file_sharded(src_path, st_s, lg_s, sinc_quality=QUALITY,
                                       device="cuda" if dev.type == "cuda" else "cpu")
    rec["lag"] = {"output": out, "launches": list(launches(kb)),
                  "wall_s": time.perf_counter() - t0}
    # K2's grid entry at lag_resample_sharded's shape: this rank's windows
    mesh = pm.Mesh(2, 2, dev)
    src, sr_src, _ = audio_io.read_file(src_path)
    nm = -(-len(src) // (2 * 256)) * (2 * 256)
    xs = pm.shard_time_batch(mesh, np.pad(src.T, ((0, 0), (0, nm - len(src)))))
    buf, bs, rel, in_seg = ps.lag_windows(mesh, xs, np.asarray(st_s) * sr_src,
                                          np.asarray(lg_s) * sr_src, nt=QUALITY)
    rows = int(bs.shape[0])
    rec["lag"]["k2_grid_entry"] = kernel_vs_plain(
        "K2's grid entry at lag_resample_sharded's shape", dev, kb.sinc_banded_gathered,
        lambda *a: kb.sinc_shift_mac(a[0], *a[1:4], 256, a[4], a[5]),
        (buf, bs, rel, in_seg, QUALITY, 32), rows * 256 * 2 * QUALITY,
        buf.numel() * 4 + bs.numel() * 13, rows, timed=timed and mesh.rank == 0)
    rec["lag"]["k2_grid_entry"]["drift"] = 32
    mesh.barrier()
    return rec


def tools_rank(dev, sr, seconds):
    """Phase 34's tool shards on a 1 x 4 mesh against the port's dense
    functions, on the take's channel 0 (fft 4096, hop 1024): the STFT, the
    iSTFT round trip, HPSS masks (kernel 31), renoise, and the centre of
    gravity and adaptive chains on its first 10 s."""
    from pyaudiorestoration_tpu_torch.models import trackers
    from pyaudiorestoration_tpu_torch.ops import decompose, fourier
    from pyaudiorestoration_tpu_torch.parallel import mesh as pm
    from pyaudiorestoration_tpu_torch.parallel import sharded as ps
    from pyaudiorestoration_tpu_torch.pipelines import renoiser

    mesh = pm.Mesh(1, 4, dev)
    mono = wow_take(sr, seconds)[:, 0]
    N = -(-len(mono) // (4 * TOOL_FFT)) * (4 * TOOL_FFT)
    x = np.zeros((1, N), np.float32)
    x[0, :len(mono)] = mono
    xs = pm.shard_time_batch(mesh, x)
    g = pm.gather_time_batch
    rec = {"backend": mesh.backend}
    wall, spec = sync_wall(mesh, lambda: ps.stft_sharded(mesh, xs, TOOL_FFT, TOOL_HOP))
    rec["stft_s"] = wall
    mag = torch.abs(spec)
    spec_g = g(mesh, torch.view_as_real(spec).contiguous(), time_axis=2)
    wall, y = sync_wall(mesh, lambda: ps.istft_sharded(
        mesh, ps.stft_sharded(mesh, xs, TOOL_FFT, TOOL_HOP, "hann"), TOOL_FFT, TOOL_HOP,
        "hann"))
    rec["stft_istft_s"] = wall
    y = g(mesh, y)
    wall, (mh, mp) = sync_wall(mesh, lambda: ps.hpss_sharded(mesh, mag, kernel_size=31))
    rec["hpss_s"] = wall
    mh, mp = g(mesh, mh, time_axis=2), g(mesh, mp, time_axis=2)
    # a flat -30 dB threshold: the noise floor (~-65 dB) far below, the tone above
    profile = np.full(TOOL_FFT // 2 + 1, -30.0, np.float32)
    wall, rn = sync_wall(mesh, lambda: ps.renoise_sharded(mesh, xs, profile, -20.0,
                                                          TOOL_FFT, TOOL_HOP, "hann"))
    rec["renoise_s"] = wall
    rn = g(mesh, rn)
    n10 = min(N, 4 * TOOL_HOP * (int(10 * sr) // (4 * TOOL_HOP)))
    short = pm.shard_time_batch(mesh, x[:, :n10])
    smag = torch.abs(ps.stft_sharded(mesh, short, TOOL_FFT, TOOL_HOP))
    f0_bin = F0 * TOOL_FFT / sr
    NL0, NU0 = np.array([int(f0_bin) - 4]), np.array([int(f0_bin) + 5])
    hist0 = np.full((1, 4), np.log2(F0), np.float32)
    wall, cog = sync_wall(mesh, lambda: ps.cog_sharded(mesh, smag, NL0, NU0, 1.0 / 12.0,
                                                       TOOL_FFT, sr))
    rec["cog_s"] = wall
    wall, ada = sync_wall(mesh, lambda: ps.adaptive_peak_sharded(
        mesh, smag, hist0, 1.0, "Linear", TOOL_FFT, sr))
    rec["adaptive_s"] = wall
    cog, ada = g(mesh, cog), g(mesh, ada)
    smag_g = g(mesh, smag, time_axis=2)
    if mesh.rank != 0:
        return rec
    xt = torch.as_tensor(x[0], device=dev)
    dense = fourier.stft(xt, TOOL_FFT, TOOL_HOP, center=False).cpu().numpy()
    got = spec_g[0, ..., 0] + 1j * spec_g[0, ..., 1]
    T = dense.shape[1]
    rec["stft_rel_err"] = float(np.abs(got[:, :T] - dense).max() / np.abs(dense).max())
    sl = slice(TOOL_FFT, N - TOOL_FFT)
    rec["istft_err"] = float(np.abs(y[0, sl] - x[0, sl]).max())
    mag_d = torch.as_tensor(np.abs(got), device=dev)
    dh, dp = decompose.hpss(mag_d, kernel_size=31, mask=True)
    rec["hpss_err"] = max(float(np.abs(mh[0] - dh.cpu().numpy()).max()),
                          float(np.abs(mp[0] - dp.cpu().numpy()).max()))
    sd = fourier.stft(xt, TOOL_FFT, TOOL_HOP, "hann", center=False)
    fac = renoiser._mask_fac(20.0 * torch.log10(torch.abs(sd) + 1e-7),
                             torch.as_tensor(profile, device=dev), -20.0)
    rd = fourier.istft(sd * fac, TOOL_HOP, window_name="hann", center=False,
                       length=N).cpu().numpy()
    rec["renoise_err"] = float(np.abs(rn[0, sl] - rd[sl]).max())
    with np.errstate(divide="ignore"):
        lff = torch.as_tensor(np.log2(np.maximum(fourier.fft_freqs(TOOL_FFT, sr), 1e-12))
                              .astype(np.float32), device=dev)
    frames = torch.as_tensor(smag_g[0].T.copy(), device=dev)
    cog_d = trackers._cog_scan(frames, lff, torch.tensor(int(NL0[0]), device=dev),
                               torch.tensor(int(NU0[0]), device=dev), 1.0 / 12.0,
                               TOOL_FFT, sr).cpu().numpy()
    ada_d = trackers._adaptive_peak_scan(
        frames, tuple(torch.tensor(float(v), device=dev) for v in hist0[0]), 1.0,
        "Linear", TOOL_FFT, sr).cpu().numpy()
    rec["cog_equal"] = bool(np.array_equal(cog[0], cog_d))
    rec["adaptive_equal"] = bool(np.array_equal(ada[0], ada_d))
    rec["cog_max_diff"] = float(np.abs(cog[0] - cog_d).max())
    rec["adaptive_max_diff"] = float(np.abs(ada[0] - ada_d).max())
    return rec


def takes_batch_wall(dev):
    """Phase 31's yardstick: the warm wall of ``restore_fused_takes`` on the
    8-take batch on one card (K1)."""
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    xb, lengths, NL, NU, band = mesh_batch(SR, SECONDS, 1)
    B, F = xb.shape[0], NL.shape[0]

    def takes_run():
        return rt.restore_fused_takes(xb, np.broadcast_to(NL, (B, F)),
                                      np.broadcast_to(NU, (B, F)), FFT, FFT // OVERLAP,
                                      ZEROPAD, MAX_N, QUALITY, DRIFT, backend="pallas",
                                      band=band, lengths=lengths, device=dev)
    takes_run()
    return wall_s(takes_run, 3)[0]


def nccl_runs(count):
    """Phase 31 under NCCL, one rank a card, over min(4, ``count``) cards:
    the 1 x k mesh, and 2 x 2 where there are four.  Returns each mesh's
    ranks' records, keyed "<files>x<time> nccl"."""
    from pyaudiorestoration_tpu_torch.parallel import mesh as pm

    k = min(4, count)
    shapes = [(1, k)] + ([(2, 2)] if k == 4 else [])
    multi = pm.launch(fused_mesh_rank, k, (shapes, SR, SECONDS), device="cuda")
    return {f"{s} nccl": [r[s] for r in multi] for s in multi[0]}


def report_fused_runs(runs, takes_wall, smi, on):
    """Phase 31's lines for each mesh of ``runs`` (name -> its ranks'
    records from :func:`fused_mesh_rank`) and its checks: one K1 (or K2)
    launch a rank (``on`` is 0 where no card runs the kernels), every row
    bit-equal to its solo run, K1 within ``TOL`` of K2."""
    for name, recs in runs.items():
        r0 = recs[0]
        k1 = [r["pallas_launches"] for r in recs]
        k2 = [r["xla_launches"] for r in recs]
        print(f"[{smi}] phase 31 restore_fused_sharded {name} ({r0['backend']}, "
              f"{len(recs)} rank(s), shard {r0['shard']}): grid {r0['grid']}; launches "
              f"(K1, K2) per rank with K1 {k1}, with K2 {k2}; walls K1 cold "
              f"{r0['pallas_cold_s']:.4f} s, warm "
              + ", ".join(f"{w * 1e3:.3f}" for w in r0["pallas_warm_s"])
              + " ms; K2 warm " + ", ".join(f"{w * 1e3:.3f}" for w in r0["xla_warm_s"])
              + f" ms (restore_fused_takes x8 warm {takes_wall * 1e3:.3f} ms); K1 vs K2 "
              f"max|d| {max(r['k1_vs_k2'] for r in recs):.3e}; rows bit-equal to their "
              f"solo runs {r0['rows_bit_equal']} (max|d| {max(r0['rows_max_abs_diff']):.3e});"
              f" halo exchange {r0['halo_exchange_ms']:.3f} ms, carry all_gather "
              f"{r0['carry_all_gather_ms']:.3f} ms, limbs psum {r0['limbs_psum_ms']:.3f} ms")
        for kname in ("k1_plan_entry", "k2_plan_entry"):
            print(f"[{smi}] phase 31 {kname} at the {name} shard ({r0[kname]['rows']} rows x "
                  f"max_n {MAX_N}): {kernel_line(r0[kname])}; max|d| over ranks "
                  f"{max(r[kname]['max_abs_err'] for r in recs):.3e} (tol {TOL})")
        if k1 != [[on, 0]] * len(recs) or k2 != [[0, on]] * len(recs):
            raise RuntimeError(f"restore_fused_sharded {name}: launches {k1} / {k2}, want "
                               "one K1 (or K2) launch a rank")
        if not all(r0["rows_bit_equal"]) or not max(r["k1_vs_k2"] for r in recs) <= TOL:
            raise RuntimeError(f"restore_fused_sharded {name}: rows differ from their solo "
                               f"runs {r0['rows_max_abs_diff']}")


def four_rank_world(dev, take_path, f0, export, step_paths, sr, seconds, timed=True):
    """The four-rank world of phases 31-34: one spawn, every mesh phase that
    needs four ranks, in order."""
    return {"fused": fused_mesh_rank(dev, MESH_SHAPES, sr, seconds, timed),
            "files": stereo_lag_rank(dev, take_path, f0, export, timed),
            "restore_step": restore_step_rank(dev, step_paths, timed),
            "tools": tools_rank(dev, sr, seconds)}


def step_takes(tmp, sr):
    """Phase 9's three 10 s takes of unequal length, written to ``tmp``."""
    paths = []
    for i, L in enumerate([10 * sr, 10 * sr - 7777, 10 * sr - 40001]):
        paths.append(os.path.join(tmp, f"step{i}.wav"))
        wavfile.write(paths[-1], sr, wow_take(sr, L / sr, seed=10 + i)[:L, 0])
    return paths


def kernel_line(rec):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")
    return ", ".join(f"{k} {rec[k]:.4g}" if isinstance(rec[k], float) else f"{k} {rec[k]}"
                     for k in keys)


def mesh_phases(take, sig, f0, dev, smi, export):
    """Phases 31-34 (module docstring).  ``export``: phase 15's
    ratio-corrected source (C, n) and its lag curve.  Returns the kernels'
    records at the mesh's shapes and launches, and the walls."""
    from pyaudiorestoration_tpu_torch import cli
    from pyaudiorestoration_tpu_torch.parallel import mesh as pm
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    hop = FFT // OVERLAP
    # 31 at 1 x 1: one rank, NCCL, in this process
    one = pm.launch(fused_mesh_rank, 1, ([(1, 1)], SR, SECONDS), device=dev.type)[0]["1x1"]
    _, _, NL, NU, band = mesh_batch(SR, SECONDS, 1)
    takes_wall = takes_batch_wall(dev)
    src_rows, lag_curve = export
    with tempfile.TemporaryDirectory() as tmp:
        take_path = os.path.join(tmp, "stereo.wav")
        wavfile.write(take_path, SR, take)
        src_path = os.path.join(tmp, "src_ratio.wav")
        wavfile.write(src_path, TS_SR, np.ascontiguousarray(src_rows.T))
        paths = step_takes(tmp, SR)
        t0 = time.perf_counter()
        four = pm.launch(four_rank_world, 4, (take_path, f0, (
            src_path, lag_curve[:, 0], lag_curve[:, 1]), paths, SR, SECONDS),
            device=dev.type, backend="gloo")
        four_wall = time.perf_counter() - t0
        stereo = wavfile.read(four[0]["files"]["file"]["output"])[1]
        lagged = wavfile.read(four[0]["files"]["lag"]["output"])[1]
        # 33: the fixed-length tier through the CLI, one rank on the card
        t0 = time.perf_counter()
        rc = cli.main(["respeed-batch", *paths, "--tier", "fixed", "--f0", str(F0),
                       "--fft-size", str(FFT), "--step", str(hop), "--device", dev.type])
        cli_wall = time.perf_counter() - t0
        fixed = []
        for p in paths:
            x = wavfile.read(p)[1].astype(np.float64)
            y = wavfile.read(p[:-4] + "_res.wav")[1].astype(np.float64)
            if rc != 0 or len(y) != len(x) or not np.all(np.isfinite(y)):
                raise RuntimeError(f"respeed-batch --tier fixed: rc {rc}, {p}: {y.shape}")
            fixed.append((tone_stability(x, SR), tone_stability(y, SR)))
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    multi = nccl_runs(count) if count >= 2 else {}

    # 31: every rank's launches, the rows against their solo runs (a CPU
    # rehearsal of this phase launches no kernel: the wrappers run the plain versions)
    on = int(dev.type == "cuda")
    runs = {"1x1": [one]}
    runs.update({s: [r["fused"][s] for r in four] for s in ("1x4", "2x2")})
    runs.update(multi)
    report_fused_runs(runs, takes_wall, smi, on)
    if not multi:
        print(f"[{smi}] phase 31: {count} card(s) visible, the NCCL run over several cards "
              "skipped")

    # 32: the stereo take through the mesh with its shared curve against phase 7's
    fplan = rt._fused_plan(sig[0], torch.as_tensor(NL[:len(take) // hop + 1], device=dev),
                           torch.as_tensor(NU[:len(take) // hop + 1], device=dev), FFT,
                           hop, ZEROPAD, MAX_N, QUALITY, DRIFT, "blackmanharris", band)
    grid = rt.run_banded_sinc(sig, *fplan, MAX_N, QUALITY, DRIFT, "pallas").cpu().numpy()
    nn7 = fplan[1].cpu().numpy()
    ref = np.stack([rt.compact_output(grid[c], {"n": nn7, "n_out": int(nn7.sum())})
                    for c in range(2)], -1)
    files = [r["files"] for r in four]
    equal = stereo.shape == ref.shape and np.array_equal(stereo, ref)
    print(f"[{smi}] phase 32 restore_file_sharded (2x2 gloo, channels on the files axis, "
          f"shared curve): wall {files[0]['file']['wall_s']:.3f} s, K1 launches per rank "
          f"{[f['file']['launches'][0] for f in files]}; output {stereo.shape} vs phase 7's "
          f"{ref.shape}, bit-equal {equal}")
    for c in range(2):
        compare_compacted(stereo[:, c], ref[:, c], f"phase 32 channel {c} vs phase 7")
    if [f["file"]["launches"] for f in files] != [[on, 0]] * 4:
        raise RuntimeError(f"restore_file_sharded launches {[f['file'] for f in files]}")

    # 34: the tapesync export on the mesh against the dense export
    dense = rs_dense_export(src_rows, lag_curve, dev)
    m = min(len(dense), len(lagged)) - 4096
    lag_err = float(np.abs(lagged[4096:m] - dense[4096:m]).max())
    k2_lag = [f["lag"]["launches"] for f in files]
    print(f"[{smi}] phase 34 lag_resample_file_sharded (2x2 gloo) on phase 15's pair: wall "
          f"{files[0]['lag']['wall_s']:.3f} s, K2 launches per rank {k2_lag}; lags up "
          f"to {np.abs(lag_curve[:, 1]).max() * TS_SR:.0f} samples; interior max|d| vs "
          f"the dense export {lag_err:.2e} (tol 1e-4: both round a position to float32 "
          f"relative to an anchor up to ~600 samples back, 6.1e-5 samples, at slopes "
          f"up to ~0.7 a sample); K2 grid entry at its shape: "
          f"{kernel_line(files[0]['lag']['k2_grid_entry'])}")
    if k2_lag != [[0, on]] * 4 or not lag_err <= 1e-4:
        raise RuntimeError(f"lag_resample_file_sharded: launches {k2_lag}, max|d| {lag_err}")
    tools = four[0]["tools"]
    print(f"[{smi}] phase 34 tool shards (1x4 gloo, fft {TOOL_FFT}/{TOOL_HOP}) vs the dense "
          f"port: STFT relative max|d| {tools['stft_rel_err']:.2e} (tol 1e-5), iSTFT round "
          f"trip {tools['istft_err']:.2e} (tol 1e-3), HPSS masks {tools['hpss_err']:.2e} "
          f"(tol 1e-5), renoise {tools['renoise_err']:.2e} (tol 5e-4), CoG chain equal "
          f"{tools['cog_equal']} ({tools['cog_max_diff']:.2e}), adaptive chain equal "
          f"{tools['adaptive_equal']} ({tools['adaptive_max_diff']:.2e}); walls stft "
          f"{tools['stft_s']:.3f} s, stft+istft {tools['stft_istft_s']:.3f} s, hpss "
          f"{tools['hpss_s']:.3f} s, renoise {tools['renoise_s']:.3f} s, cog "
          f"{tools['cog_s']:.3f} s, adaptive {tools['adaptive_s']:.3f} s")
    require(tools["stft_rel_err"] <= 1e-5 and tools["istft_err"] <= 1e-3
            and tools["hpss_err"] <= 1e-5 and tools["renoise_err"] <= 5e-4
            and tools["cog_equal"] and tools["adaptive_equal"],
            f"the tool shards disagree with the dense port: {tools}")

    # 33: the fixed tier's CLI and K2's grid entry at restore_step's sinc shape
    steps = [r["restore_step"] for r in four]
    k2_step = [s["launches"] for s in steps]
    cli_ranks = pm.world_ranks(dev.type)
    print(f"[{smi}] phase 33 respeed-batch --tier fixed ({cli_ranks} rank(s), "
          f"{pm.world_backend(cli_ranks, dev.type)}): 3 takes, wall {cli_wall:.3f} s; flutter "
          + ", ".join(f"{a:.2e} -> {b:.2e}" for a, b in fixed)
          + f"; restore_step sinc on the 1x4 mesh (drift halo {steps[0]['drift_halo']}):"
          f" K2 launches per rank {k2_step}, cold "
          f"{steps[0]['cold_s']:.3f} s, warm "
          + ", ".join(f"{w:.3f}" for w in steps[0]["warm_s"]) + " s, flutter "
          + ", ".join(f"{a:.2e} -> {b:.2e}" for a, b in steps[0]["flutter"])
          + f"; K2 grid entry at its shape: {kernel_line(steps[0]['k2_grid_entry'])}")
    require(all(b < 0.5 * a for a, b in fixed), f"the fixed tier's flutter {fixed}")
    require(all(b < 0.6 * a for a, b in steps[0]["flutter"]),
            f"restore_step sinc flutter {steps[0]['flutter']}")
    require(k2_step == [[0, on]] * 4, f"restore_step sinc launches {k2_step}")
    print(f"[{smi}] phases 31-34: the four-rank world took {four_wall:.1f} s")

    k1_paths = {f"restore_fused_sharded {n} ({recs[0]['backend']}, all ranks)":
                sum(r["pallas_launches"][0] for r in recs) for n, recs in runs.items()}
    k1_paths["restore_file_sharded 2x2 (gloo, all ranks)"] = sum(
        f["file"]["launches"][0] for f in files)
    k2_paths = {f"restore_fused_sharded {n} xla ({recs[0]['backend']}, all ranks)":
                sum(r["xla_launches"][1] for r in recs) for n, recs in runs.items()}
    k2_paths["restore_step sinc 1x4 (gloo, all ranks)"] = sum(s[1] for s in k2_step)
    k2_paths["lag_resample_file_sharded 2x2 (gloo, all ranks)"] = sum(s[1] for s in k2_lag)
    return {"k1_paths": k1_paths, "k2_paths": k2_paths,
            "k1": {f"plan_entry_at_mesh_{n}": recs[0]["k1_plan_entry"]
                   for n, recs in runs.items()},
            "k2": {**{f"plan_entry_at_mesh_{n}": recs[0]["k2_plan_entry"]
                      for n, recs in runs.items()},
                   "grid_entry_at_restore_step_sinc": steps[0]["k2_grid_entry"],
                   "grid_entry_at_lag_resample_sharded": files[0]["lag"]["k2_grid_entry"]},
            "walls": {"restore_fused_takes_x8_warm_s": takes_wall,
                      **{f"restore_fused_sharded {n} warm_s": recs[0]["pallas_warm_s"]
                         for n, recs in runs.items()},
                      **{f"{n} halo/carry/psum ms": [recs[0]["halo_exchange_ms"],
                                                     recs[0]["carry_all_gather_ms"],
                                                     recs[0]["limbs_psum_ms"]]
                         for n, recs in runs.items()},
                      "restore_file_sharded_s": files[0]["file"]["wall_s"],
                      "lag_resample_file_sharded_s": files[0]["lag"]["wall_s"],
                      "respeed-batch --tier fixed_s": cli_wall,
                      "four_rank_world_s": four_wall, "tools": tools}}


def rs_dense_export(src_rows, lag_curve, dev):
    """tapesync's own export of the (C, n) source through the lag curve:
    ``lag_to_pos`` positions and ``sinc_resample`` (K1's grid entry)."""
    from pyaudiorestoration_tpu_torch.ops import resampling as rs

    n = src_rows.shape[1]
    pos = rs.lag_to_pos(lag_curve[:, 0] * TS_SR, lag_curve[:, 1] * TS_SR, n)
    return rs.sinc_resample(np.ascontiguousarray(src_rows.T), pos, quality=QUALITY,
                            device=dev)


def main_multi():
    """``python3 chip_smoke.py --multi``, on a machine of two cards or more:
    phase 31 under NCCL alone, one rank a card over min(4, cards) (the
    kernels built first), beside ``restore_fused_takes``' wall on one
    card; the ranks' records as JSON on the last line."""
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.utils.device import resolve_device

    count = torch.cuda.device_count()
    if count < 2:
        print(f"chip_smoke --multi: {count} card(s), needs two or more", file=sys.stderr)
        return 2
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True, timeout=60).stdout.strip().splitlines()
    print("\n".join(cards))
    smi = cards[0]
    t0 = time.perf_counter()
    print(f"build: kernels {kb.build().name} in {time.perf_counter() - t0:.2f} s")
    takes_wall = takes_batch_wall(resolve_device("cuda"))
    t0 = time.perf_counter()
    runs = nccl_runs(count)
    print(f"[{smi}] phase 31 under NCCL over {len(next(iter(runs.values())))} cards: the "
          f"world took {time.perf_counter() - t0:.1f} s")
    report_fused_runs(runs, takes_wall, smi, 1)
    print(json.dumps({"restore_fused_takes_x8_warm_s": takes_wall,
                      **{name: recs[0] for name, recs in runs.items()}}))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--multi"]:
        return main_multi()
    from pyaudiorestoration_tpu_torch import cli
    from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
    from pyaudiorestoration_tpu_torch.utils import audio_io
    from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch
    from pyaudiorestoration_tpu_torch.utils.device import resolve_device

    started = time.perf_counter()
    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    # the host too: the card-vs-CPU phases compare against its float32 BLAS
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}; host {platform.machine()}, "
          f"{platform.processor() or 'processor not named'}")
    dev = resolve_device("cuda")

    # 2. build both libraries from the checkout, together: K1 and K2 (nvcc)
    # and the audio codec (the host C++ compiler)
    built = {}

    def build(name, fn):
        t = time.perf_counter()
        try:
            built[name] = (fn(), time.perf_counter() - t)
        except Exception as e:  # reported below, in the main thread
            built[name] = (e, time.perf_counter() - t)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=a)
               for a in (("kernels", kb.build), ("codec", audio_io.build))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    build_s = time.perf_counter() - t0
    for name, (res, secs) in built.items():
        if isinstance(res, Exception):
            raise RuntimeError(f"building the {name} failed") from res
        print(f"build: {name} {res.name} in {secs:.2f} s")

    # 3. K1's plan entry against its plain version at the main path's shape
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
    if drift > 64:
        raise RuntimeError(f"take's drift bucket {drift} is over 64")
    k1 = check_plan_kernel("K1", sig, (speeds, p["n"], p["base_int"], p["base_frac"]),
                           p["max_n"], QUALITY, drift, seed=3)

    # 4. the main path end to end through the CLI
    argv = ["--fast", "--device", "cuda", "--fft-size", str(FFT), "--fft-overlap",
            str(OVERLAP), "--zeropad", str(ZEROPAD), "--sinc-quality", str(QUALITY)]
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "take.wav")
        wavfile.write(src, SR, take)
        reset_launches(kb)
        t0 = time.perf_counter()
        rc = cli.main(["respeed", src, *argv])
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        k1_fast = launches(kb)
        if rc != 0 or k1_fast != (1, 0):
            raise RuntimeError(f"respeed --fast: rc {rc}, launches {k1_fast}, want one K1")
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
    print(f"respeed --fast: {SECONDS:.0f} s take, K1 launches {k1_fast[0]}, "
          f"cold {cold_s:.3f} s (+ build {build_s:.2f} s), warm {warm_s:.3f} s "
          f"(runs {', '.join(f'{w:.3f}' for w in warm)}), "
          f"{SECONDS / warm_s:.1f}x realtime; flutter {before:.2e} -> {after:.2e}")
    if not after < 0.2 * before:
        raise RuntimeError("flutter did not drop below 0.2x the input's")

    # 5. the card's restore against the port's CPU path on a small take
    card_vs_cpu_restore(rt)

    # 6. K2's plan entry against its plain version at the fused path's shape
    NLs = torch.full((n_frames,), NL, dtype=torch.int32, device=dev)
    NUs = torch.full((n_frames,), NU, dtype=torch.int32, device=dev)
    band = (NL - 1, NU + 1)
    fplan = rt._fused_plan(sig[0], NLs, NUs, FFT, hop, ZEROPAD, MAX_N, QUALITY, DRIFT,
                           "blackmanharris", band)
    k2 = check_plan_kernel("K2", sig, fplan, MAX_N, QUALITY, DRIFT, seed=4)

    # 7-9. the fused single take, the batches and respeed-batch
    k1_fused, k2_fused = fused_single(sig, NLs, NUs, band, fplan[1], take, dev)
    k1_batch = fused_batch(sig[0], NLs, NUs, band, dev)
    k1_cli = cli_batch()

    # 10-12. the streamed tier, the portable path, the other trackers
    k1_stream = streamed_phase(take, dev)
    k1_portable, k1_resample = portable_phase(take, sig, dev)
    modes_phase(dev)

    # 13-15. heal, dropouts-batch and tapesync through the CLI
    heal = heal_phase(dev, smi)
    batch = dropouts_batch_phase(dev, smi)
    tape, k1_tapesync, export = tapesync_phase(dev, smi)

    # 16-24. the spectral and analysis tools through the CLI
    tools = {"difeq": difeq_phase(take, dev, smi), "expand": expand_phase(dev, smi),
             "hpss": hpss_phase(take, dev, smi)}
    tools["renoise"], k1_renoise = renoise_phase(take, dev, smi)
    tools["humspeed"], k1_hum, k1_hum_stream = humspeed_phase(take, dev, smi)
    tools.update({"pan": pan_phase(take, dev, smi),
                  "decompress": decompress_phase(take, dev, smi),
                  "group-delay": group_delay_phase(dev, smi),
                  "cyclic-wow": cyclic_wow_phase(dev, smi)})

    # 25-30. the user-facing surface through the CLI
    mpl = importlib.util.find_spec("matplotlib") is not None
    surface = {"view": view_phase(take, dev, smi)}
    surface["listen"], surface["measure"] = listen_measure_phase(take, dev, smi)
    surface["tapesync --compare"] = compare_phase(dev, smi, tape, mpl)
    surface["doctor"] = doctor_phase(smi)
    forms = matplotlib_forms(take, dev, mpl)

    # 31-34. the mesh tier over torch.distributed ranks
    mesh = mesh_phases(take, sig, f0, dev, smi, export)

    print(f"chip_smoke: phases 1-34 in {time.perf_counter() - started:.1f} s")
    common = {"route": "cuda", "source": "pyaudiorestoration_tpu_torch/csrc/sinc_banded.cu"}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "sinc_banded", **common,
         "replaces": "pyaudiorestoration_tpu/kernels/sinc_pallas.py:253",
         "entry": "sinc_banded_plan_f32", "launches": k1_fast[0],
         **{k: k1[k] for k in keys},
         "launches_by_path": {"respeed --fast": k1_fast[0],
                              "restore_fused_device pallas": k1_fused,
                              "restore_fused_takes x8": k1_batch,
                              "respeed-batch": k1_cli,
                              "respeed (streamed, auto route)": k1_stream,
                              **k1_portable,
                              "tapesync": tape["k1 resample_ratio"] + tape["k1 run"],
                              "tapesync (resample_ratio)": tape["k1 resample_ratio"],
                              "tapesync (run)": tape["k1 run"],
                              "renoise --noise (resample_ratio)":
                                  tools["renoise"][f"noise_{RN_NOISE_SR}"]["k1_launches"],
                              "humspeed (resample_ratio)": tools["humspeed"]["k1_launches"],
                              "humspeed --stream (plan entry)":
                                  tools["humspeed"]["k1_stream_launches"],
                              "tapesync --compare":
                                  surface["tapesync --compare"]["k1_launches"],
                              "doctor's probe (its child process)":
                                  surface["doctor"]["k1_launches"],
                              **mesh["k1_paths"]},
         **{k: v for k, v in k1.items() if k not in keys},
         "grid_entry_at_sinc_resample": k1_resample,
         "grid_entry_at_tapesync_resample_ratio": k1_tapesync["resample_ratio"],
         "grid_entry_at_tapesync_run": k1_tapesync["run"],
         "grid_entry_at_humspeed_resample_ratio": k1_hum,
         "grid_entry_at_renoise_noise_resample": k1_renoise,
         "plan_entry_at_humspeed_stream": k1_hum_stream, **mesh["k1"]},
        {"name": "sinc_banded_gathered", **common,
         "replaces": "pyaudiorestoration_tpu/kernels/sinc_pallas.py:350",
         "entry": "sinc_banded_gathered_plan_f32", "launches": k2_fused,
         **{k: k2[k] for k in keys},
         "launches_by_path": {"restore_fused_device xla": k2_fused, **mesh["k2_paths"]},
         **{k: v for k, v in k2.items() if k not in keys}, **mesh["k2"]}],
        "walls_s": {"heal": heal, "dropouts-batch": batch, "tapesync": tape, **tools,
                    **surface, "mesh": mesh["walls"]},
        "matplotlib_forms": forms}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
