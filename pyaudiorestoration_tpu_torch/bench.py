"""The port's benchmark: wow/flutter restoration of a 192 kHz stereo take on
one CUDA card (the counterpart of the repository's root ``bench.py``).

    python3 -m pyaudiorestoration_tpu_torch bench
    python3 -m pyaudiorestoration_tpu_torch.bench

Prints bench.py's two JSON lines, in its order, as the last two lines of
stdout: the single stereo take through ``restore_fused_device`` (carrying
the batch's figure as ``batch8_x_realtime``), then 8 independent takes
through ``restore_fused_takes``.  Each line has bench.py's fields, then
``device`` (the card's name, its power limit from ``nvidia-smi`` and the
card count), ``input``, ``backend``, ``k1_launches_per_call`` and
``flutter_before`` / ``flutter_after`` (the batch line's of its row 0); the
first line ends with ``probe_s``, the wall of the device probe.

The steps are bench.py's (bench.py:49-155):

1. a device probe in a child process, bounded at 600 s (``doctor``'s: a
   tiny op, then K1's grid entry, which builds the kernel library when
   ``build/torch_kernels/`` lacks it).  Where the card is missing or wrong
   it prints one line on stderr and exits 3: nothing is timed on the CPU;
2. the take: the audio file named by ``BENCH_SAMPLE`` (bench.py reads the
   reference's ``samples/flutter_192.flac``) tiled to ``BENCH_SECONDS``
   (default 30), or else ``utils/synth.wow_take``; stereo as
   ``[mono, 0.8 mono]``;
3. the plan's parameters from the host rFFT of the first 2**18 samples
   (:func:`plan_params`); fft 4096, overlap 8, zeropad 2, quality 50,
   drift 16;
4. each tier uploaded once, then timed: the first call in the process
   (``wall_cold_s``: cuFFT and cuBLAS set-up, K1's library load); then
   *serialized* runs, one call and a synchronize each (5, then 3); then,
   after two warm-up calls, *pipelined* sets of ``k_pipe`` calls back to
   back (16, then 6), each output folded into one device scalar and one
   synchronize a set, wall / ``k_pipe`` (2 sets).  The headline ``value``
   is the best pipelined set, as in bench.py; every run is listed;
5. the output checked before a speed is reported: K1 launched once a call
   and K2 never; the compacted take's flutter (``utils/synth.
   tone_stability``) under 0.2x the input's; the batch's row 0 within 1e-6
   of its solo ``restore_fused_device`` run.  A failed check prints one
   line on stderr and exits 1, with no metric line.

Imports ``torch``, numpy and the port only.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SAMPLE = os.environ.get("BENCH_SAMPLE") or None  # an audio file to tile; else synthesized
SR_SYNTH = 192_000
FFT, OVERLAP, ZEROPAD, QUALITY, DRIFT = 4096, 8, 2, 50, 16  # bench.py:85, 132
TAKES = 8  # the batch tier (bench.py:138)
FLUTTER_DROP = 0.2  # flutter after < 0.2x before, as chip_smoke holds it
ROW0_TOL = 1e-6  # the batch's row 0 against its solo run


class CheckFailed(RuntimeError):
    """An output check failed: no speed is reported."""


def load_take(seconds: float):
    """(mono float32 (n,), sample rate, input name): channel 0 of the file
    ``SAMPLE`` tiled ``int(seconds * sr / len)`` times (at least once;
    bench.py:68-70), or, with no ``SAMPLE``, the synthesized ``wow_take``
    of ``seconds`` at 192 kHz."""
    if SAMPLE:
        from .utils import audio_io

        sig, sr, _ = audio_io.read_file(SAMPLE)
        reps = max(1, int(seconds * sr / len(sig)))
        return np.tile(sig[:, 0], reps), sr, f"{os.path.basename(SAMPLE)} x{reps}"
    from .utils.synth import wow_take

    return (wow_take(SR_SYNTH, seconds, seed=0)[:, 0], SR_SYNTH,
            f"synthesized wow_take({SR_SYNTH}, {seconds:g} s, seed=0)")


def plan_params(mono, sr: int) -> dict:
    """bench.py:74-95: the pilot ``f0`` from the host rFFT of the first 2**18
    samples under a Hann window; ``NL``/``NU``, the bins of f0 -+ 1/12
    octave; ``n_frames``, ``hop``, ``max_n = int(hop * 1.1)`` and ``band =
    (NL - 1, NU + 1)``."""
    probe = mono[: 1 << 18]
    spec = np.abs(np.fft.rfft(probe * np.hanning(len(probe))))
    f0 = float(np.argmax(spec[10:]) + 10) / len(probe) * sr
    hop = FFT // OVERLAP
    n = len(mono)
    tol = 1.0 / 12
    num_bins = FFT * ZEROPAD // 2 + 1
    NL = max(1, min(num_bins - 1, int(round(max(1.0, f0 * 2 ** -tol) * FFT * ZEROPAD / sr))))
    NU = max(1, min(num_bins - 1, int(round(min(sr / 2, f0 * 2 ** tol) * FFT * ZEROPAD / sr))))
    n_frames = (n + (FFT // 2) * 2 - FFT) // hop + 1
    return {"f0": f0, "NL": NL, "NU": NU, "n_frames": n_frames, "hop": hop,
            "max_n": int(hop * 1.1), "band": (NL - 1, NU + 1)}


def card_info(dev) -> dict:
    """The card's name (torch), its power limit in watts (``nvidia-smi``;
    None where it cannot be read) and the card count; on the CPU, "cpu"."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 0}
    limit = None
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip().splitlines()
        print(f"bench: nvidia-smi: {lines[dev.index or 0]}", file=sys.stderr)
        limit = float(lines[dev.index or 0].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError) as e:
        print(f"bench: warning: no power limit from nvidia-smi ({e!r})", file=sys.stderr)
    return {"name": torch.cuda.get_device_name(dev), "power_limit_w": limit,
            "count": torch.cuda.device_count()}


def time_tier(dispatch, dev, k_pipe: int, n_serial: int, n_sets: int):
    """One tier, timed as the module docstring says.  Returns (the first
    call's output, its wall, serialized walls, pipelined walls a call, K1
    launches a call, K2 launches in all)."""
    from .kernels import sinc_banded as kb

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()  # the upload is out of the timed region
    kb.reset_launches()
    t0 = time.perf_counter()
    first = dispatch()
    sync()
    cold = time.perf_counter() - t0
    serial = []
    for _ in range(n_serial):
        t0 = time.perf_counter()
        dispatch()
        sync()
        serial.append(time.perf_counter() - t0)
    acc = torch.zeros((), device=dev)
    for _ in range(2):  # warm the fold (sum + add) outside the timed sets
        acc = acc + dispatch().sum()
    sync()
    pipe, folds = [], []
    for _ in range(n_sets):
        acc = torch.zeros((), device=dev)
        t0 = time.perf_counter()
        for _ in range(k_pipe):
            acc = acc + dispatch().sum()
        sync()
        pipe.append((time.perf_counter() - t0) / k_pipe)
        folds.append(float(acc))
    k1, k2 = kb.launches()
    calls = 1 + n_serial + 2 + n_sets * k_pipe
    if not all(math.isfinite(f) for f in folds):
        raise CheckFailed(f"the folded outputs are not finite: {folds}")
    per_call = k1 / calls
    return first, cold, serial, pipe, int(per_call) if per_call.is_integer() else per_call, k2


def run_tiers(mono, sr: int, device="cuda", input_name: str = "", k_pipe=(16, 6),
              n_serial=(5, 3), n_sets: int = 2):
    """Time both tiers on ``mono`` (n,) float32 and check their output;
    returns the two line dicts (the first without ``probe_s``).  Raises
    :class:`CheckFailed` where a check fails.  ``k_pipe`` and ``n_serial``
    are (single, batch); the defaults are bench.py's."""
    from .pipelines import respeeder_device as rt
    from .utils.device import resolve_device
    from .utils.synth import tone_stability

    dev = resolve_device(device)
    want_k1 = 1 if dev.type == "cuda" else 0  # the CPU runs the plain versions
    p = plan_params(mono, sr)
    hop, max_n, band = p["hop"], p["max_n"], p["band"]
    backend = rt._sinc_backend("auto", dev)
    NLs = torch.full((p["n_frames"],), p["NL"], dtype=torch.int32, device=dev)
    NUs = torch.full((p["n_frames"],), p["NU"], dtype=torch.int32, device=dev)
    args = (FFT, hop, ZEROPAD, max_n, QUALITY, DRIFT)
    common = {"device": card_info(dev), "input": input_name, "backend": backend}

    def flutter(x, padded):
        """Flutter of the take ``x`` (n,) and of its compacted grid ``padded``."""
        n = rt._fused_plan(x, NLs, NUs, *args, "blackmanharris", band)[1]
        out, _ = rt.compact_padded_device(padded, n, int(n.sum()))
        return (tone_stability(x.cpu().numpy().astype(np.float64), sr),
                tone_stability(out.cpu().numpy().astype(np.float64), sr))

    def check(what, k1, k2, before, after):
        print(f"bench: {what}: K1 launches a call {k1}, K2 launches {k2}; flutter "
              f"{before:.3e} -> {after:.3e}", file=sys.stderr)
        if k1 != want_k1 or k2 != 0:
            raise CheckFailed(f"{what}: K1 launches a call {k1}, K2 launches {k2}; "
                              f"want {want_k1} and 0")
        if not after < FLUTTER_DROP * before:
            raise CheckFailed(f"{what}: flutter {before:.3e} -> {after:.3e}, not under "
                              f"{FLUTTER_DROP}x")
        return {**common, "k1_launches_per_call": k1, "flutter_before": before,
                "flutter_after": after}

    # ---- single stereo take (bench.py:129-136) ----
    sig = torch.as_tensor(np.stack([mono, mono * 0.8]), device=dev)
    audio_s = sig.shape[1] / sr

    def run_single():
        return rt.restore_fused_device(sig, NLs, NUs, *args, backend=backend, band=band,
                                       device=dev)

    grid, cold, serial, pipe, k1, k2 = time_tier(run_single, dev, k_pipe[0], n_serial[0],
                                                 n_sets)
    single_extra = check("single take", k1, k2, *flutter(sig[0], grid[0]))
    del sig, grid
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- 8 independent takes (bench.py:137-155) ----
    takes = torch.as_tensor(np.stack([mono * (0.5 + 0.06 * i) for i in range(TAKES)]),
                            device=dev)
    NLb, NUb = NLs.expand(TAKES, -1), NUs.expand(TAKES, -1)
    batch_audio_s = TAKES * takes.shape[1] / sr

    def run_batch():
        return rt.restore_fused_takes(takes, NLb, NUb, *args, backend=backend, band=band,
                                      device=dev)

    grids, bcold, bserial, bpipe, bk1, bk2 = time_tier(run_batch, dev, k_pipe[1],
                                                       n_serial[1], n_sets)
    solo = rt.restore_fused_device(takes[0], NLs, NUs, *args, backend=backend, band=band,
                                   device=dev)
    row0 = float((grids[0] - solo).abs().max())
    print(f"bench: batch row 0 vs its solo run: max|d| {row0:.3e} (tol {ROW0_TOL})",
          file=sys.stderr)
    if not row0 <= ROW0_TOL:
        raise CheckFailed(f"the batch's row 0 is {row0} from its solo run")
    batch_extra = check("batch row 0", bk1, bk2, *flutter(takes[0], grids[0]))
    del takes, grids, solo

    rtf = audio_s / min(pipe)
    batch_rtf = batch_audio_s / min(bpipe)
    first = {
        "metric": "192kHz stereo flutter-correction realtime factor (PyTorch port, "
                  "1 CUDA card, device-resident, steady-state)",
        **_rates(rtf, audio_s, cold, serial, pipe),
        "batch8_x_realtime": round(batch_rtf, 2), **single_extra}
    second = {
        "metric": "8-take independent batch aggregate realtime factor (PyTorch port, "
                  "1 CUDA card, restore_fused_takes, steady-state)",
        **_rates(batch_rtf, batch_audio_s, bcold, bserial, bpipe), **batch_extra}
    return first, second


def _rates(rtf, audio_s, cold, serial, pipe) -> dict:
    """bench.py's fields of one line, in its order, up to ``audio_s``."""
    value = round(rtf, 2)
    return {"value": value, "unit": "x_realtime", "vs_baseline": round(value / 100.0, 3),
            "x_realtime_serialized": round(audio_s / min(serial), 2),
            "runs_serialized_x_realtime": [round(audio_s / t, 1) for t in serial],
            "pipelined_sets_x_realtime": [round(audio_s / t, 1) for t in pipe],
            "wall_cold_s": round(cold, 3), "audio_s": round(audio_s, 2)}


def main() -> int:
    """Probe, time, check, print; returns the exit code (0, 1 or 3)."""
    from .utils.doctor import _probe_devices

    t0 = time.perf_counter()
    status, info = _probe_devices(600.0)
    probe_s = time.perf_counter() - t0
    if status == "ok" and not (info.get("tiny_op_ok") and info.get("k1_ok")):
        status = "wrong_result"
    if status != "ok":
        print(f"bench: device runtime unavailable ({status}): {info}", file=sys.stderr)
        return 3
    print(f"bench: device probe ok in {probe_s:.2f} s: {info}", file=sys.stderr)
    mono, sr, name = load_take(float(os.environ.get("BENCH_SECONDS", "30")))
    try:
        first, second = run_tiers(mono, sr, "cuda", name)
    except CheckFailed as e:
        print(f"bench: check failed, no speed reported: {e}", file=sys.stderr)
        return 1
    first["probe_s"] = round(probe_s, 3)
    print(json.dumps(first))
    print(json.dumps(second))
    return 0


if __name__ == "__main__":
    sys.exit(main())
