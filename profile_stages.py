"""Stage breakdown and device profile of the port's ``respeed --fast`` on one
CUDA card, on chip_smoke's 30 s, 192 kHz stereo take.

    python3 profile_stages.py [--runs 5]

Prints the card's name and power limit, then the median wall milliseconds of
each stage of ``restore_file_fast`` (a synchronize after each), then one
``torch.profiler`` run of ``restore_file_fast``: its wall, the device's busy
time (union of device events), its idle share of the wall, and the device
time by kernel.  Imports no JAX.
"""

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from scipy.io import wavfile
from torch.profiler import ProfilerActivity, profile

from chip_smoke import FFT, OVERLAP, QUALITY, SECONDS, SR, ZEROPAD, wow_take


def stage_times(src, rt, plan_to_torch, audio_io, dev):
    """One run of restore_file_fast's in-memory path, split into stages."""
    t, last = {}, [time.perf_counter()]
    start = last[0]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        t[name] = (now - last[0]) * 1e3
        last[0] = now

    signal, sr, nch = audio_io.read_file(src)
    mark("read")
    f0 = rt._probe_f0(signal[:, 0], sr)
    mark("probe")
    sig = torch.as_tensor(np.ascontiguousarray(signal.T), device=dev)
    mark("upload")
    hop = FFT // OVERLAP
    n = len(signal)
    n_frames = n // hop + 1
    NL, NU = rt._band_limits(f0, 1.0, FFT, ZEROPAD, sr)
    speeds = rt.track_speed_device(
        sig[0], torch.full((n_frames,), NL, dtype=torch.int32, device=dev),
        torch.full((n_frames,), NU, dtype=torch.int32, device=dev),
        FFT, hop, ZEROPAD, band=(NL - 1, NU + 1))
    mark("track")
    plan = rt.plan_positions_fast(speeds.cpu().numpy(), hop, n)
    p = plan_to_torch(plan, dev)
    mark("plan")
    padded = rt.run_banded_sinc(sig, speeds, p["n"], p["base_int"], p["base_frac"],
                                p["max_n"], QUALITY, rt._drift_bucket(p["drift"]))
    mark("sinc")
    out, _ = rt.compact_padded_device(padded, p["n"], int(plan["n_out"]))
    mark("compact")
    host = out.T.contiguous().cpu().numpy()
    mark("download")
    audio_io.write_file(src, host, sr, nch, suffix="_res")
    mark("write")
    t["total"] = (time.perf_counter() - start) * 1e3
    return t


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages: torch sees no CUDA card")
    from pyaudiorestoration_tpu.utils import audio_io  # the path's own codec
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
    from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch
    from pyaudiorestoration_tpu_torch.utils.device import resolve_device

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = resolve_device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "take.wav")
        wavfile.write(src, SR, wow_take(SR, SECONDS))
        stage_times(src, rt, plan_to_torch, audio_io, dev)  # build and warm up
        runs = [stage_times(src, rt, plan_to_torch, audio_io, dev)
                for _ in range(args.runs)]
        print(f"stages, ms (median of {args.runs}):")
        for k in runs[0]:
            print(f"  {k:9s} {statistics.median(r[k] for r in runs):9.3f}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rt.restore_file_fast(src, fft_size=FFT, fft_overlap=OVERLAP,
                                 zeropad=ZEROPAD, sinc_quality=QUALITY, device=dev)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, cur = 0.0, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur is None or s > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy += 0.0 if cur is None else cur[1] - cur[0]
    print(f"profiled run: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({len(events)} device events), idle share {1 - busy / wall_us:.3f}")
    by = {}
    for e in events:
        acc = by.setdefault(e.name[:80], [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    for name, (us, count) in sorted(by.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {us / 1e3:9.3f} ms  n={count:4d}  {name}")


if __name__ == "__main__":
    main()
