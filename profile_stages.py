"""Stage breakdown and device profile of the port's paths on one CUDA card,
on chip_smoke's synthesized inputs.

    python3 profile_stages.py [--path fast|fused|batch|stream|portable|heal|heuristic|tapesync
                                     |hpss|renoise|humspeed|expand|view|listen] [--runs 5]
    python3 profile_stages.py --sass

``fast``: ``restore_file_fast`` (``respeed --fast``), file to file.
``fused``: ``restore_fused_device`` on the stereo take (bench.py:130-133).
``batch``: ``restore_fused_takes`` on 8 takes of it (bench.py:143-155).
``stream``: ``restore_file_streamed`` (the streamed tier) on chip_smoke's
12-minute take (1.1 GB decoded), file to file, split into its passes.
``portable``: ``respeeder.restore_file`` (``respeed`` at the CLI defaults:
Peak, fft 1024/8/4, sinc 50), file to file.
``heal``: ``dropouts.heal_file`` at the CLI defaults (fft 512/16) on the
30 s take with chip_smoke's 8 dropouts, file to file.
``heuristic``: ``dropouts.process_heuristic`` (``dropouts-batch`` at its
defaults: fft 1024/4, 12 bands, 3-12 kHz) on the 30 s take with 6 dips.
``tapesync``: ``tapesynch.align_files`` at the defaults on chip_smoke's
60 s 44.1 kHz pair (the source 5 % fast and 60 ms late).
``hpss``: ``hpss_tool.separate_file`` at the defaults (fft 2048/4, kernel
31) on the 30 s take with chip_smoke's clicks.
``renoise``: ``renoiser.process_file`` with ``--selection 0.5 1.5`` at the
defaults (fft 1024/4, gain -40 dB) on the 30 s take.
``humspeed``: ``analyze_hum`` and the in-memory ``resample_file`` (K1's grid
entry, one launch a channel) on the take with chip_smoke's 1.5 % fast hum.
``expand``: ``expander.expand_file`` at the defaults on chip_smoke's take
with a stepped hiss floor (the entry reads the file twice, as JAX's).
``view``: the ``view`` CLI at its defaults (fft 1024/4, izo) with ``--trail``
on the pilot of the 30 s take, split into read, STFT, trace, the device
render with its download, and the page (PNG deflate, base64, write).
``listen``: the ``listen`` CLI on the take and a copy at half level, split
into read, the two strips (STFT, render, PNG) and the two 16-bit WAVs
with their base64, and the write.
``heuristic``, ``hpss``, ``renoise``, ``humspeed`` and ``expand`` time the
entry itself through its ``timings=`` dict; the other paths mark stages
around the entry's own pieces.
The fused paths run K1 (backend "pallas"), as the card's "auto" does; the
streamed and portable paths run K1 through their own resamplers.  The sinc
stage of every path includes its grids: K1's plan entry builds them.
``--sass``: build K1/K2 and count, from ``cuobjdump -sass``, the issued
instructions a tap of each unrolled tap loop (a block of 7 taps, or two).

Prints the card's name and power limit, then the median wall milliseconds of
each stage (a synchronize after each), then one ``torch.profiler`` run of
the path's entry: its wall, the device's busy time (union of device events),
its idle share of the wall, and the device time by kernel.  Imports no JAX.
"""

import argparse
import contextlib
import inspect
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch
from scipy.io import wavfile
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (DRIFT, FFT, HUM, LONG_MINUTES, MAX_N, N_DIPS, N_DROPS, OVERLAP,
                        QUALITY, SECONDS, SR, TS_SECONDS, TS_SR, VIEW_FFT, VIEW_HOP,
                        ZEROPAD, dips_take, dropout_take, hiss_take, long_wow_chunks,
                        save_drop, tapesync_pair, write_float_wav)
from pyaudiorestoration_tpu_torch.utils.synth import F0, wow_take

HOP = FFT // OVERLAP
VIEW_TRAIL = ((0.5, F0), (SECONDS - 0.5, F0))  # chip_smoke's view --trail


class Stages:
    """Wall milliseconds between marks, each after a synchronize."""

    def __init__(self):
        self.t = {}
        self.start = self.last = time.perf_counter()

    def mark(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.t[name] = (now - self.last) * 1e3
        self.last = now

    def done(self):
        self.t["total"] = (time.perf_counter() - self.start) * 1e3
        return self.t


def fast_stages(src, rt, plan_to_torch, audio_io, dev):
    """One run of restore_file_fast's in-memory path, split into stages."""
    s = Stages()
    signal, sr, nch = audio_io.read_file(src)
    s.mark("read")
    f0 = rt._probe_f0(signal[:, 0], sr)
    s.mark("probe")
    sig = torch.as_tensor(np.ascontiguousarray(signal.T), device=dev)
    s.mark("upload")
    n = len(signal)
    n_frames = n // HOP + 1
    NL, NU = rt._band_limits(f0, 1.0, FFT, ZEROPAD, sr)
    speeds = rt.track_speed_device(
        sig[0], torch.full((n_frames,), NL, dtype=torch.int32, device=dev),
        torch.full((n_frames,), NU, dtype=torch.int32, device=dev),
        FFT, HOP, ZEROPAD, band=(NL - 1, NU + 1))
    s.mark("track")
    plan = rt.plan_positions_fast(speeds.cpu().numpy(), HOP, n)
    p = plan_to_torch(plan, dev)
    s.mark("plan")
    padded = rt.run_banded_sinc(sig, speeds, p["n"], p["base_int"], p["base_frac"],
                                p["max_n"], QUALITY, rt._drift_bucket(p["drift"]))
    s.mark("sinc")
    out, _ = rt.compact_padded_device(padded, p["n"], int(plan["n_out"]))
    s.mark("compact")
    host = out.T.contiguous().cpu().numpy()
    s.mark("download")
    audio_io.write_file(src, host, sr, nch, suffix="_res")
    s.mark("write")
    return s.done()


def fused_stages(x_host, shared_curve, NLs, NUs, band, rt, dev):
    """One run of the fused path split into stages: rows of ``x_host`` are
    the channels of one take (``shared_curve``, restore_fused_device) or
    independent takes (restore_fused_takes), through K1."""
    s = Stages()
    x = torch.as_tensor(x_host, device=dev)
    s.mark("upload")
    rows = x[:1] if shared_curve else x
    speeds = torch.stack([rt.track_speed_device(r, NLs, NUs, FFT, HOP, ZEROPAD,
                                                band=band) for r in rows])
    s.mark("track")
    speeds, n, bi, bf = rt._plan_from_speeds(speeds, HOP, MAX_N, DRIFT)
    s.mark("plan scans")
    B = x.shape[0]
    flat = rt._flatten_takes(x, speeds.expand(B, -1), n.expand(B, -1),
                             bi.expand(B, -1), bf.expand(B, -1), MAX_N, QUALITY, DRIFT)
    out = rt._sinc_segments_backend(flat, MAX_N, QUALITY, DRIFT, "pallas")
    s.mark("sinc")  # K1's plan entry, its grids included
    out.cpu()
    s.mark("download")
    return s.done()


STREAM_STAGES = ("pass1_read_s", "pass1_device_s", "pass1_s", "plan_s", "pass2_read_s",
                 "pass2_device_dl_s", "pass2_write_s", "pass2_s")


def stream_stages(src, rt, dev):
    """One run of the streamed tier; its own per-pass timings, in ms."""
    timings = {}
    t0 = time.perf_counter()
    rt.restore_file_streamed(src, fft_size=FFT, fft_overlap=OVERLAP, zeropad=ZEROPAD,
                             sinc_quality=QUALITY, resume=False, timings=timings,
                             device=dev)
    torch.cuda.synchronize()
    out = {k[:-2]: timings[k] * 1e3 for k in STREAM_STAGES}
    out["total"] = (time.perf_counter() - t0) * 1e3
    return out


def portable_stages(src, rp, rs, audio_io, dev):
    """One run of ``respeeder.restore_file`` at the CLI defaults, split into
    stages (K1 once per channel, as ``sinc_resample``'s banded branch)."""
    fft, overlap, zeropad, quality = 1024, 8, 4, 50
    s = Stages()
    signal, sr, nch = audio_io.read_file(src)
    n = len(signal)
    s.mark("read")
    spectrum, hop = rp.compute_spectrum(signal, sr, fft, overlap, zeropad, device=dev)
    s.mark("spectrum")
    f0 = (int(np.argmax(spectrum.mean(axis=1)[1:])) + 1) / (fft * zeropad) * sr
    line = rp.trace_trail(signal, sr, [(0.0, f0), (n / sr, f0)], "Peak", fft, overlap,
                          zeropad, spectrum=spectrum, device=dev)
    s.mark("trace")
    curve = rp.get_speed_curve([line], [], sr, hop, n / sr)
    s.mark("curve")
    pos = rs.speed_to_pos(curve[:, 0] * sr, curve[:, 1], n)
    anchors, rel, fc, drift = rs.banded_layout(pos, rs._positions_to_device_args(pos)[2])
    anchors, rel, fc = (torch.as_tensor(v, device=dev) for v in (anchors, rel, fc))
    s.mark("positions")
    sig = torch.as_tensor(signal, device=dev)
    s.mark("upload")
    out = torch.stack([rs._sinc_banded_blocks(sig[:, c].contiguous(), anchors, rel, fc,
                                              quality, drift).reshape(-1)
                       for c in range(nch)], -1)[:len(pos)]
    s.mark("K1")
    host = out.cpu().numpy()
    s.mark("download")
    audio_io.write_file(src, host, sr, suffix="_res")
    s.mark("write")
    return s.done()


def heal_stages(src, drop, audio_io, dev):
    """One run of ``heal_file``'s in-memory path (``heal --project``), split
    into stages."""
    from pyaudiorestoration_tpu_torch.ops import fourier
    from pyaudiorestoration_tpu_torch.pipelines import dropouts
    from pyaudiorestoration_tpu_torch.utils import project

    s = Stages()
    signal, sr, nch = audio_io.read_file(src)
    proj = project.Project.load(drop)
    fft, hop, n = proj.fft_size, proj.hop, len(signal)
    boxes = dropouts._boxes_array(proj.marker_list("dropouts"), sr, hop, fft)
    s.mark("read")
    x = torch.as_tensor(np.ascontiguousarray(fourier.fix_length(signal, n + fft // 2,
                                                                axis=0).T), device=dev)
    s.mark("upload")
    spec = fourier.stft(x, n_fft=fft, step=hop)
    s.mark("STFT")
    healed = dropouts._heal_spectrum(spec, boxes)
    s.mark("mask")
    y = fourier.istft(healed, length=n, hop_length=hop)
    s.mark("iSTFT")
    host = y.cpu().numpy().T
    s.mark("download")
    audio_io.write_file(src, host, sr, nch, suffix="_drops")
    s.mark("write")
    return s.done()


def entry_stages(entry):
    """One run of ``entry(timings)``, a pipeline entry that fills its own
    ``timings=`` dict (``utils.timing.Stages``: a synchronize before each
    mark), in ms, in the entry's order."""
    timings = {}
    t0 = time.perf_counter()
    entry(timings)
    torch.cuda.synchronize()
    out = {k[:-2]: v * 1e3 for k, v in timings.items()}
    out["total"] = (time.perf_counter() - t0) * 1e3
    return out


def tapesync_stages(ref, src, audio_io, dev):
    """One run of ``align_files`` at its defaults, split into stages (the
    resample stage uploads, runs K1 once a channel and downloads)."""
    from pyaudiorestoration_tpu_torch.ops import resampling as rs
    from pyaudiorestoration_tpu_torch.pipelines import tapesynch as ts

    defaults = {k: p.default for k, p in inspect.signature(ts.align_files).parameters.items()}
    s = Stages()
    ref_sig, sr, _ = audio_io.read_file(ref)
    src_sig, _, _ = audio_io.read_file(src)
    s.mark("read")
    _, curve = ts.auto_align(ref_sig, src_sig, sr, **{k: defaults[k] for k in (
        "num_windows", "window_s", "lower", "upper", "smoothing")}, device=dev)
    s.mark("auto_align")  # ratio, windows, K1 x8, band-pass, find_delay, curve
    pos = rs.lag_to_pos(curve[:, 0] * sr, curve[:, 1] * sr, len(src_sig))
    s.mark("positions")
    out = rs.sinc_resample(src_sig, pos, quality=defaults["sinc_quality"], device=dev)
    s.mark("resample")
    audio_io.write_file(src, out, sr, suffix="_res")
    s.mark("write")
    return s.done()


def view_stages(src, audio_io, dev):
    """One run of ``view --trail`` on the pilot at its defaults, split into
    the CLI's stages."""
    from pyaudiorestoration_tpu_torch.models import trackers, viz_html
    from pyaudiorestoration_tpu_torch.ops import fourier

    s = Stages()
    sig, sr, _ = audio_io.read_file(src)
    s.mark("read")
    mag = fourier.get_mag(sig[:, 0], VIEW_FFT, VIEW_HOP, device=dev)
    s.mark("upload + STFT")
    times, freqs = trackers.trace("Peak", mag, sig, VIEW_TRAIL, VIEW_FFT, VIEW_HOP, sr,
                                  device=dev)
    s.mark("trace")
    rgb, meta = viz_html.render_rgb(mag, sr, VIEW_HOP, device=dev)
    s.mark("render + download")
    viz_html._write_page(src[:-4] + ".html", "take", meta, json.dumps(
        [{"t": list(map(float, times)), "f": list(map(float, freqs)), "color": "#ff5050"}]),
        rgb)
    s.mark("page")
    return s.done()


def listen_stages(paths, audio_io, dev):
    """One run of ``listen`` on two takes, split into its stages."""
    from pyaudiorestoration_tpu_torch.models import audition

    s = Stages()
    takes = [audio_io.read_file(p)[0] for p in paths]
    s.mark("read")
    strips = [audition._strip_png(x, SR, device=dev) for x in takes]
    s.mark("strips")
    wavs = [audition._wav16_b64(x, SR) for x in takes]
    s.mark("WAVs + base64")
    with open(paths[0][:-4] + ".html", "w", encoding="utf-8") as f:
        f.write("".join(strips + wavs))
    s.mark("write")
    return s.done()


def device_profile(fn):
    """One profiled run of ``fn``: wall, device busy time and idle share, and
    the device time by kernel."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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


def sass_report(so):
    """Instructions a tap of each unrolled tap loop of the kernels in the
    shared library ``so``: every backward branch whose body holds a MUFU.RCP
    and the taper's LDS.128 loads (two a block of 7 taps)."""
    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(shutil.which("nvcc") or
                                                              "/usr/local/cuda/bin/nvcc")),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        name = func.split("\n")[0]
        entry = re.search(r"WindowE(\d)ELNS_5GridsE(\d)", name)
        label = ("K1" if entry.group(1) == "1" else "K2") + (
            " plan" if entry.group(2) == "0" else " grids") if entry else name[:60]
        ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
               re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", func)]
        index = {a: i for i, (a, _) in enumerate(ins)}
        print(f"{label}: {len(ins)} instructions")
        for i, (a, text) in enumerate(ins):
            m = re.search(r"BRA (?:!?U?P\d, )?0x([0-9a-f]+)", text)
            if not m or int(m.group(1), 16) >= a or int(m.group(1), 16) not in index:
                continue
            body = [t for _, t in ins[index[int(m.group(1), 16)]:i + 1]]
            taps = 7 * sum("LDS.128" in t for t in body) // 2
            if not taps or not any("MUFU.RCP" in t for t in body) or len(body) > 400:
                continue
            ops = {}
            for t in body:
                op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                ops[op] = ops.get(op, 0) + 1
            predicated = sum(t.startswith("@") for t in body)
            print(f"  loop {int(m.group(1), 16):#06x}-{a:#06x}: {len(body)} instructions "
                  f"for {taps} taps = {len(body) / taps:.2f} a tap ({predicated} "
                  f"predicated); " + ", ".join(f"{k} {v}" for k, v in
                                              sorted(ops.items(), key=lambda kv: -kv[1])))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=["fast", "fused", "batch", "stream", "portable",
                                       "heal", "heuristic", "tapesync", "hpss", "renoise",
                                       "humspeed", "expand", "view", "listen"],
                    default="fast")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--sass", action="store_true",
                    help="count the tap loops' instructions in the built kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages: torch sees no CUDA card")
    if args.sass:
        from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb

        sass_report(kb.build())
        return
    from pyaudiorestoration_tpu_torch.ops import resampling as rs
    from pyaudiorestoration_tpu_torch.pipelines import respeeder as rp
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
    from pyaudiorestoration_tpu_torch.utils import audio_io
    from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch
    from pyaudiorestoration_tpu_torch.utils.device import resolve_device

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0])
    dev = resolve_device("cuda")
    take = wow_take(SR, SECONDS)
    with tempfile.TemporaryDirectory() as tmp:
        if args.path == "fast":
            src = os.path.join(tmp, "take.wav")
            wavfile.write(src, SR, take)

            def stages():
                return fast_stages(src, rt, plan_to_torch, audio_io, dev)

            def entry():
                rt.restore_file_fast(src, fft_size=FFT, fft_overlap=OVERLAP,
                                     zeropad=ZEROPAD, sinc_quality=QUALITY, device=dev)
        elif args.path == "stream":
            src = os.path.join(tmp, "long.wav")
            n = LONG_MINUTES * 60 * SR
            write_float_wav(src, SR, 2, n, long_wow_chunks(SR, n, dev))
            print(f"stream: {LONG_MINUTES} min, {os.path.getsize(src) / 1e9:.3f} GB")

            def stages():
                return stream_stages(src, rt, dev)

            def entry():
                rt.restore_file_streamed(src, fft_size=FFT, fft_overlap=OVERLAP,
                                         zeropad=ZEROPAD, sinc_quality=QUALITY,
                                         resume=False, device=dev)
        elif args.path == "heal":
            src, drop = os.path.join(tmp, "take.wav"), os.path.join(tmp, "take.drop")
            take, _, boxes = dropout_take(SR, SECONDS, N_DROPS)
            wavfile.write(src, SR, take)
            save_drop(drop, boxes)

            def stages():
                return heal_stages(src, drop, audio_io, dev)

            def entry():
                from pyaudiorestoration_tpu_torch.pipelines import dropouts
                from pyaudiorestoration_tpu_torch.utils import project

                dropouts.heal_file(src, project.Project.load(drop).marker_list("dropouts"),
                                   stream=False, device=dev)
        elif args.path == "heuristic":
            src = os.path.join(tmp, "dips.wav")
            wavfile.write(src, SR, dips_take(SR, SECONDS, N_DIPS)[0])

            def entry(timings=None):
                from pyaudiorestoration_tpu_torch.pipelines import dropouts

                dropouts.process_heuristic(src, stream=False, device=dev, timings=timings)

            def stages():
                return entry_stages(entry)
        elif args.path == "tapesync":
            ref, src = os.path.join(tmp, "ref.wav"), os.path.join(tmp, "src.wav")
            for path, x in zip((ref, src), tapesync_pair(TS_SR, TS_SECONDS)):
                wavfile.write(path, TS_SR, x)

            def stages():
                return tapesync_stages(ref, src, audio_io, dev)

            def entry():
                from pyaudiorestoration_tpu_torch.pipelines import tapesynch

                tapesynch.align_files(ref, src, device=dev)
        elif args.path in ("hpss", "renoise", "humspeed", "expand"):
            src = os.path.join(tmp, "take.wav")
            x = hiss_take(SR, SECONDS) if args.path == "expand" else take.copy()
            if args.path == "hpss":
                x[np.arange(SR // 4, len(x) - 1, SR // 4)] += 0.8
            elif args.path == "humspeed":
                t = np.arange(len(x)) / SR
                x += sum(0.05 * np.sin(2 * np.pi * f * t) for f in HUM)[:, None].astype(
                    np.float32)
            wavfile.write(src, SR, x)

            def entry(timings=None):
                from pyaudiorestoration_tpu_torch.pipelines import (expander, hpss_tool,
                                                                     humspeed, renoiser)

                kw = dict(stream=False, device=dev, timings=timings)
                if args.path == "hpss":
                    hpss_tool.separate_file(src, **kw)
                elif args.path == "renoise":
                    renoiser.process_file(src, selection=(0.5, 1.5), **kw)
                elif args.path == "humspeed":
                    humspeed.resample_file(src, **kw)
                else:
                    expander.expand_file(src, **kw)

            def stages():
                return entry_stages(entry)
        elif args.path == "view":
            src = os.path.join(tmp, "take.wav")
            wavfile.write(src, SR, take)

            def stages():
                return view_stages(src, audio_io, dev)

            def entry():
                from pyaudiorestoration_tpu_torch import cli

                trail = [str(v) for p in VIEW_TRAIL for v in p]
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(["view", src, "--trail", *trail, "--device", str(dev)])
        elif args.path == "listen":
            paths = [os.path.join(tmp, "a.wav"), os.path.join(tmp, "b.wav")]
            wavfile.write(paths[0], SR, take)
            wavfile.write(paths[1], SR, 0.5 * take)

            def stages():
                return listen_stages(paths, audio_io, dev)

            def entry():
                from pyaudiorestoration_tpu_torch import cli

                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(["listen", *paths, "-o", os.path.join(tmp, "aud.html"),
                              "--device", str(dev)])
        elif args.path == "portable":
            src = os.path.join(tmp, "take.wav")
            wavfile.write(src, SR, take)

            def stages():
                return portable_stages(src, rp, rs, audio_io, dev)

            def entry():
                rp.restore_file(src, fft_size=1024, fft_overlap=8, zeropad=4,
                                sinc_quality=50, device=dev)
        else:
            NL, NU = rt._band_limits(rt._probe_f0(take[:, 0], SR), 1.0, FFT, ZEROPAD, SR)
            frames = take.shape[0] // HOP + 1
            NLs = torch.full((frames,), NL, dtype=torch.int32, device=dev)
            NUs = torch.full((frames,), NU, dtype=torch.int32, device=dev)
            band = (NL - 1, NU + 1)
            if args.path == "fused":
                x_host = np.ascontiguousarray(take.T)
            else:
                x_host = np.stack([take[:, 0] * (0.5 + 0.06 * i) for i in range(8)])
            print(f"{args.path}: input {x_host.shape}, {x_host.nbytes / 1e6:.1f} MB")

            def stages():
                return fused_stages(x_host, args.path == "fused", NLs, NUs, band, rt,
                                    dev)

            x_dev = torch.as_tensor(x_host, device=dev)

            def entry():
                if args.path == "fused":
                    return rt.restore_fused_device(x_dev, NLs, NUs, FFT, HOP, ZEROPAD,
                                                   MAX_N, QUALITY, DRIFT, backend="pallas",
                                                   band=band, device=dev)
                B = x_dev.shape[0]
                return rt.restore_fused_takes(x_dev, NLs.expand(B, -1), NUs.expand(B, -1),
                                              FFT, HOP, ZEROPAD, MAX_N, QUALITY, DRIFT,
                                              backend="pallas", band=band, device=dev)
        stages()  # build and warm up
        runs = [stages() for _ in range(args.runs)]
        print(f"stages, ms (median of {args.runs}):")
        for k in runs[0]:
            print(f"  {k:10s} {statistics.median(r[k] for r in runs):9.3f}")
        entry()
        device_profile(entry)


if __name__ == "__main__":
    main()
