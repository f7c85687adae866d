"""Command-line interface of the PyTorch/CUDA port.

    python -m pyaudiorestoration_tpu_torch respeed <audio|project.spd> [...] [--device cuda]
    python -m pyaudiorestoration_tpu_torch respeed-batch <audio>... [--device cuda]
    python -m pyaudiorestoration_tpu_torch tapesync <ref> <src> | <x.tapesync> [--compare x.html]
    python -m pyaudiorestoration_tpu_torch heal <audio> --project x.drop | --detect ...
    python -m pyaudiorestoration_tpu_torch dropouts-batch <audio>... [--mode MaxMono]
    python -m pyaudiorestoration_tpu_torch difeq <src> <ref> -o out [...]
    python -m pyaudiorestoration_tpu_torch expand <audio> [...]
    python -m pyaudiorestoration_tpu_torch hpss <audio>... [...]
    python -m pyaudiorestoration_tpu_torch renoise <audio> --noise n.wav | --selection T0 T1
    python -m pyaudiorestoration_tpu_torch humspeed <audio> [--analyze-only]
    python -m pyaudiorestoration_tpu_torch pan <audio> --project x.pan
    python -m pyaudiorestoration_tpu_torch decompress <src> <ref> [--sync]
    python -m pyaudiorestoration_tpu_torch group-delay <ref> <src> [...]
    python -m pyaudiorestoration_tpu_torch cyclic-wow <audio> [--rpm 45]
    python -m pyaudiorestoration_tpu_torch view <audio> [-o x.html] [--trail T F ...]
    python -m pyaudiorestoration_tpu_torch listen <audio> [<restored>] [-o audition.html]
    python -m pyaudiorestoration_tpu_torch measure <audio> [<other>] [--metric ...]
    python -m pyaudiorestoration_tpu_torch doctor [--no-device]

``respeed`` has every form of ``pyaudiorestoration_tpu``'s subcommand, with
its flags and defaults plus ``--device``: the portable trackers (``--mode``,
``--trail``, ``--adaptation``, ``--resampling-mode``, ``--save-project``),
``.spd`` project replay, the device pipeline (``--fast``) and the streamed
two-pass tier (``--stream``, or automatically for takes over 1 GiB
decoded).  ``respeed-batch`` restores independent takes over a
('files', 'time') mesh of ranks: ``--tier fused`` (the device plan and
banded sinc per take) or ``--tier fixed`` (the fixed-length tier, which
needs ``--f0``).  Run plainly it meshes over every visible card (one rank
on the CPU); under ``torchrun`` it joins torchrun's group.  ``bench``
exits with a "not ported yet" error.  Every other subcommand takes the JAX
package's flags and defaults (its cli.py:93-279) plus ``--device``.  ``view``, ``listen`` and
``tapesync --compare x.html`` write self-contained HTML pages whose images
are rendered on the device; ``tapesync --compare x.png`` and ``renoise
--preview`` draw matplotlib figures and need matplotlib.  ``doctor`` exits
2 when unhealthy.  The file-to-file tools stream past 1 GiB decoded or with
``--stream``.  The global ``--flac-out [BITS]`` / ``--flac-fast`` write
FLAC instead of float WAV.  ``--device cuda`` (the default) raises without
a card; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_fft_args(p, fft_size=1024, overlap=4, zeropad=1):
    p.add_argument("--fft-size", type=int, default=fft_size)
    p.add_argument("--fft-overlap", type=int, default=overlap)
    p.add_argument("--zeropad", type=int, default=zeropad)


def _add_device_arg(p):
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")


def build_parser():
    from .models.viz_html import CMAPS

    p = argparse.ArgumentParser(prog="pyaudiorestoration_tpu_torch",
                                description="audio restoration on PyTorch/CUDA")
    p.add_argument("--flac-out", nargs="?", const=24, type=int, default=None,
                   metavar="BITS",
                   help="write outputs as FLAC (native encoder) instead of "
                        "float32 WAV; optional bit depth 16 or 24 (default 24)."
                        " Applies to in-memory AND streamed export paths")
    p.add_argument("--flac-fast", action="store_true",
                   help="with --flac-out: fixed-predictor-only encoding "
                        "(like `flac -0`)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("respeed", help="wow & flutter removal (pyrespeeder)")
    sp.add_argument("input", help="audio file or .spd project")
    sp.add_argument("--mode", default="Peak",
                    choices=["Peak", "Peak Track", "Center of Gravity",
                             "Zero-Crossing", "Freehand Draw", "Correlation"])
    sp.add_argument("--trail", type=float, nargs="+", default=None,
                    metavar="T F", help="trail points t0 f0 t1 f1 ...")
    _add_fft_args(sp, 1024, 8, 4)
    sp.add_argument("--tolerance", type=float, default=1.0)
    sp.add_argument("--adaptation", default="None",
                    choices=["None", "Constant", "Linear", "Average"],
                    help="band prediction mode for Peak tracing "
                         "(adapt_band, wow_detection.py:142-187)")
    sp.add_argument("--resampling-mode", default="Sinc", choices=["Sinc", "Linear"])
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--fast", action="store_true",
                    help="device-resident pipeline (auto pilot-tone tracking)")
    sp.add_argument("--stream", action="store_true",
                    help="two-pass streamed restore for files larger than "
                         "memory (implies --fast)")
    sp.add_argument("--f0", type=float, default=None,
                    help="target frequency for --fast tracking")
    sp.add_argument("--save-project", action="store_true",
                    help="write the traced markers to <audio>.spd (GUI Save parity)")
    _add_device_arg(sp)

    sp = sub.add_parser("respeed-batch",
                        help="wow/flutter fix of a batch of independent takes")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--f0", type=float, default=None,
                    help="pilot/target frequency to track (auto-probed when "
                         "omitted)")
    sp.add_argument("--fft-size", type=int, default=512)
    sp.add_argument("--step", type=int, default=128)
    sp.add_argument("--tier", default="fused", choices=["fused", "fixed"],
                    help="fused = the device plan and banded sinc per take; "
                         "fixed = the fixed-length linear tier")
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--zeropad", type=int, default=1)
    _add_device_arg(sp)

    sp = sub.add_parser("tapesync", help="align source to reference (pytapesynch)")
    sp.add_argument("reference")
    sp.add_argument("source", nargs="?", help="omit when reference is a .tapesync project")
    sp.add_argument("--windows", type=int, default=8)
    sp.add_argument("--window-s", type=float, default=1.0)
    sp.add_argument("--lower", type=float, default=100.0)
    sp.add_argument("--upper", type=float, default=None)
    sp.add_argument("--smoothing", type=int, default=3)
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--save-project", action="store_true",
                    help="write lag markers to <source>.tapesync (GUI Save parity)")
    sp.add_argument("--compare", metavar="PNG_OR_HTML",
                    help="write a red/green overlay of reference vs aligned "
                         "output (the GUI's 2-source compare view); a .html "
                         "target gets the interactive pan/zoom viewer")
    _add_device_arg(sp)

    sp = sub.add_parser("heal", help="dropout healing (dropout_healer)")
    sp.add_argument("input")
    sp.add_argument("--project", help=".drop project with markers")
    sp.add_argument("--detect", nargs=4, type=float, metavar=("T0", "T1", "F0", "F1"),
                    help="auto-detect inside this region instead")
    sp.add_argument("--width-ms", type=float, default=20.0)
    sp.add_argument("--sensitivity", type=float, default=5.0)
    _add_fft_args(sp, 512, 16)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")
    _add_device_arg(sp)

    sp = sub.add_parser("dropouts-batch", help="batch heuristic dropout repair")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--mode", default="Heuristic", choices=["Heuristic", "MaxMono"])
    _add_fft_args(sp, 1024, 4)
    # heuristic tuning (the reference's DropsWidget, widgets.py:686-765)
    sp.add_argument("--max-width", type=float, default=0.02,
                    help="max dropout width in seconds")
    sp.add_argument("--max-slope", type=float, default=0.5,
                    help="max dB/frame slant around a dropout")
    sp.add_argument("--num-bands", type=int, default=12)
    sp.add_argument("--bottom-freedom", type=float, default=2.0)
    sp.add_argument("--f-lower", type=float, default=3000.0)
    sp.add_argument("--f-upper", type=float, default=12000.0)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")
    _add_device_arg(sp)

    sp = sub.add_parser("difeq", help="differential EQ (difeq)")
    sp.add_argument("source")
    sp.add_argument("reference")
    sp.add_argument("-o", "--output", required=True, help="output base path (.txt)")
    sp.add_argument("--channels", default="L+R", choices=["L+R", "L", "R"])
    sp.add_argument("--smoothing", type=int, default=50)
    sp.add_argument("--strength", type=float, default=1.0)
    sp.add_argument("--keep-gain", action="store_true")
    sp.add_argument("--highpass", type=float, default=0)
    sp.add_argument("--rolloff-start", type=float, default=21000)
    sp.add_argument("--rolloff-end", type=float, default=22000)
    _add_device_arg(sp)

    sp = sub.add_parser("expand", help="spectral expander (expander)")
    sp.add_argument("input")
    sp.add_argument("--channels", default="L+R", choices=["L+R", "L", "R", "Mean"])
    sp.add_argument("--band-lower", type=float, default=13000)
    sp.add_argument("--band-upper", type=float, default=17000)
    sp.add_argument("--clip-lower", type=float, default=-120)
    sp.add_argument("--clip-upper", type=float, default=-85)
    sp.add_argument("--smoothing-s", type=float, default=0.11)
    sp.add_argument("--transition", type=float, default=0)
    sp.add_argument("--order", type=int, default=1)
    sp.add_argument("--suffix", default="_decompressed")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")
    _add_device_arg(sp)

    sp = sub.add_parser("humspeed", help="hum-based speed analysis/correction")
    sp.add_argument("input")
    sp.add_argument("--base-hum", type=int, default=50)
    sp.add_argument("--harmonies", type=int, default=2)
    sp.add_argument("--tolerance", type=float, default=8)
    sp.add_argument("--analyze-only", action="store_true")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory resample")
    _add_device_arg(sp)

    sp = sub.add_parser("pan", help="pan matching (pypan)")
    sp.add_argument("input")
    sp.add_argument("--project", required=True, help=".pan project with markers")
    _add_device_arg(sp)

    sp = sub.add_parser("renoise", help="renoiser / denoiser")
    sp.add_argument("input")
    sp.add_argument("--noise", help="noise profile audio file")
    sp.add_argument("--selection", nargs=2, type=float, metavar=("T0", "T1"),
                    help="noise span inside the input")
    sp.add_argument("--gain", type=float, default=-40.0)
    sp.add_argument("--overhead", type=float, default=0.0)
    sp.add_argument("--preview", metavar="PNG",
                    help="write a before/after masked-spectrogram image via "
                         "the re-mask-only fast path (no audio output)")
    _add_fft_args(sp, 1024, 4)
    sp.add_argument("--suffix", default=None,
                    help="output suffix (default: ' fft=<size>')")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")
    _add_device_arg(sp)

    sp = sub.add_parser("hpss", help="harmonic/percussive separation")
    sp.add_argument("inputs", nargs="+")
    sp.add_argument("--kernel", type=int, default=31)
    sp.add_argument("--power", type=float, default=2.0)
    sp.add_argument("--margin", type=float, default=1.0)
    _add_fft_args(sp, 2048, 4)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")
    _add_device_arg(sp)

    sp = sub.add_parser("decompress", help="transfer a reference's dynamics "
                        "onto a compressed source (decompressor)")
    sp.add_argument("source", help="dynamically compressed file to fix")
    sp.add_argument("reference", help="file with the target dynamics")
    sp.add_argument("--hop", type=int, default=32)
    sp.add_argument("--rms-size", type=int, default=512,
                    help="RMS window size (samples)")
    sp.add_argument("--lower", type=float, default=80.0)
    sp.add_argument("--upper", type=float, default=9000.0)
    sp.add_argument("--smoothing", type=float, default=0.08,
                    metavar="SEC", help="gain-curve smoothing (seconds)")
    sp.add_argument("--sync", action="store_true",
                    help="cross-correlate the RMS envelopes and align first")
    sp.add_argument("--stream", action="store_true",
                    help="force the blockwise larger-than-memory path")
    _add_device_arg(sp)

    sp = sub.add_parser("group-delay", help="per-band delay & correlation "
                        "between two takes (group_delay diagnostics)")
    sp.add_argument("reference")
    sp.add_argument("source")
    sp.add_argument("--lower", type=float, default=10.0)
    sp.add_argument("--upper", type=float, default=2000.0)
    sp.add_argument("--bandwidth", type=float, default=45.0)
    sp.add_argument("--order", type=int, default=1)
    sp.add_argument("--min-corr", type=float, default=0.6,
                    help="report only bands above this correlation")
    _add_device_arg(sp)

    sp = sub.add_parser("cyclic-wow", help="once-per-rotation wow analysis "
                        "of a record transfer (cyclic_wow)")
    sp.add_argument("input")
    sp.add_argument("--rpm", type=float, default=45.0, help="nominal record speed")
    sp.add_argument("--f0", type=float, default=700.0, help="tone to trace")
    sp.add_argument("--fft-size", type=int, default=16384)
    sp.add_argument("--tolerance", type=float, default=0.1,
                    help="cycle-length search range (fraction of nominal)")
    sp.add_argument("--curve-out", metavar="TXT",
                    help="write the averaged cycle curve (one value per "
                         "frame, semitones) to a text file")
    _add_device_arg(sp)

    sp = sub.add_parser("view", help="interactive HTML spectrogram viewer")
    sp.add_argument("input")
    sp.add_argument("-o", "--output", default=None, help="output .html (default <input>.html)")
    _add_fft_args(sp, 1024, 4)
    sp.add_argument("--channel", type=int, default=0)
    sp.add_argument("--cmap", default="izo", choices=CMAPS)
    sp.add_argument("--trail", type=float, nargs="+", default=None,
                    metavar="T F", help="overlay a traced Peak curve from this trail")
    _add_device_arg(sp)

    sp = sub.add_parser("listen", help="self-contained HTML audition page "
                        "(playback cursor + A/B, the GUI AudioWidget headless)")
    sp.add_argument("inputs", nargs="+", help="one or two audio files (A/B)")
    sp.add_argument("-o", "--output", default="audition.html")
    sp.add_argument("--start", type=float, default=0.0, help="start seconds")
    sp.add_argument("--seconds", type=float, default=60.0,
                    help="max embedded duration")
    _add_device_arg(sp)

    sp = sub.add_parser("measure", help="quality metrics (flutter / SNR / spectral distance)")
    sp.add_argument("input")
    sp.add_argument("compare_to", nargs="?", default=None,
                    help="second file for SNR / spectral distance")
    sp.add_argument("--metric", default="all",
                    choices=["all", "flutter", "snr", "spectral"])
    _add_device_arg(sp)

    sub.add_parser("bench", help="run the benchmark (not ported yet)")

    sp = sub.add_parser("doctor", help="bounded environment/device health "
                        "checks (codec, kernel build, device runtime)")
    sp.add_argument("--device-timeout", type=float, default=120.0,
                    help="seconds before declaring the device runtime wedged")
    sp.add_argument("--no-device", action="store_true",
                    help="skip the device probe (codec/kernel-build checks only)")
    sp.add_argument("--device", default="cuda",
                    help="torch device the probe checks: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.flac_out is not None:
        from .utils import audio_io

        audio_io.set_output_format("flac", bits=args.flac_out,
                                   level=0 if args.flac_fast else 1)
    run = {"respeed": _respeed, "respeed-batch": _respeed_batch, "tapesync": _tapesync,
           "heal": _heal, "dropouts-batch": _dropouts_batch, "difeq": _difeq,
           "expand": _expand, "humspeed": _humspeed, "pan": _pan, "renoise": _renoise,
           "hpss": _hpss, "decompress": _decompress, "group-delay": _group_delay,
           "cyclic-wow": _cyclic_wow, "view": _view, "listen": _listen,
           "measure": _measure, "bench": _bench, "doctor": _doctor}[args.cmd]
    try:
        out = run(args)
    except NotImplementedError as e:
        print(f"error: not ported yet: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out if isinstance(out, dict) else {"outputs": out}))
    if args.cmd == "doctor":
        return 0 if out["healthy"] else 2
    return 0


def _respeed(args):
    from .pipelines import respeeder

    stream = True if args.stream else "auto"
    if args.input.endswith(".spd"):
        return respeeder.run_project(args.input, out_suffix=args.suffix,
                                     stream=stream, device=args.device)
    if args.fast or args.stream:
        from .pipelines import respeeder_device

        return [respeeder_device.restore_file_fast(
            args.input, f0_hz=args.f0, tolerance_st=args.tolerance,
            fft_size=args.fft_size, fft_overlap=args.fft_overlap,
            zeropad=args.zeropad, sinc_quality=args.sinc_quality,
            suffix=args.suffix, stream=stream, device=args.device)]
    trail = None
    if args.trail:
        pts = args.trail
        trail = [(pts[i], pts[i + 1]) for i in range(0, len(pts), 2)]
    return respeeder.restore_file(
        args.input, mode=args.mode, fft_size=args.fft_size,
        fft_overlap=args.fft_overlap, zeropad=args.zeropad,
        tolerance=args.tolerance, trail=trail,
        resampling_mode=args.resampling_mode, sinc_quality=args.sinc_quality,
        suffix=args.suffix, save_project=args.save_project, adapt=args.adaptation,
        device=args.device)


def _respeed_batch(args):
    from .parallel import batch

    if args.tier == "fixed":
        if args.f0 is None:
            raise ValueError("--tier fixed requires --f0")
        return batch.restore_batch_files(args.inputs, args.f0, n_fft=args.fft_size,
                                         step=args.step, device=args.device)
    return batch.restore_batch_files_fused(
        args.inputs, args.f0, fft_size=args.fft_size,
        fft_overlap=max(1, args.fft_size // args.step), zeropad=args.zeropad,
        sinc_quality=args.sinc_quality, device=args.device)


def _tapesync(args):
    from .pipelines import tapesynch
    from .utils import project

    ref, src = args.reference, args.source
    if ref.endswith(".tapesync"):
        proj = project.Project.load(ref)
        ref = proj.settings.get("reference")
        src = src or proj.settings.get("source")
    paths, samples, _ = tapesynch.align_files(
        ref, src, out_suffix=args.suffix, num_windows=args.windows,
        window_s=args.window_s, lower=args.lower, upper=args.upper,
        smoothing=args.smoothing, sinc_quality=args.sinc_quality,
        save_project=args.save_project, device=args.device)
    out = {"outputs": paths, "lags": [s.to_cfg() for s in samples]}
    if args.compare:
        from .ops import fourier
        from .utils import audio_io

        ref_sig, sr, _ = audio_io.read_file(ref)
        out_sig, _, _ = audio_io.read_file(paths[0])
        fft, hop = 1024, 256
        mag_a = fourier.get_mag(ref_sig[:, 0], fft, hop, device=args.device)
        mag_b = fourier.get_mag(out_sig[:, 0], fft, hop, device=args.device)
        if args.compare.endswith(".html"):
            from .models import viz_html

            out["compare"] = viz_html.save_interactive_compare_html(
                args.compare, mag_a, mag_b, sr, hop, device=args.device)
        else:
            from .models import viz

            out["compare"] = viz.save_comparison(args.compare, mag_a, mag_b, sr, hop,
                                                 device=args.device)
    return out


def _heal(args):
    from .pipelines import dropouts
    from .utils import project

    if args.project:
        proj = project.Project.load(args.project)
        drops = proj.marker_list("dropouts")
        fft_size, overlap = proj.fft_size, proj.fft_overlap
    elif args.detect is None:
        raise ValueError("heal needs either --project or --detect T0 T1 F0 F1")
    else:
        from .ops import fourier, units
        from .utils import audio_io

        fft_size, overlap = args.fft_size, args.fft_overlap
        signal, sr, _ = audio_io.read_file(args.input)
        hop = fft_size // overlap
        mag = fourier.get_mag(signal[:, 0], fft_size, hop, device=args.device)
        t0, t1, f0, f1 = args.detect
        drops = dropouts.detect_dropouts(units.to_dB(mag.cpu().numpy()), sr, hop,
                                         fft_size, t0, t1, f0, f1, args.width_ms,
                                         args.sensitivity)
    out = dropouts.heal_file(args.input, drops, fft_size, overlap, suffix=args.suffix,
                             stream=True if args.stream else "auto", device=args.device)
    return {"outputs": [out], "num_dropouts": len(drops)}


def _dropouts_batch(args):
    from .pipelines import dropouts

    stream = True if args.stream else "auto"
    outs = []
    for path in args.inputs:
        if args.mode == "Heuristic":
            outs.append(dropouts.process_heuristic(
                path, args.fft_size, args.fft_overlap, max_width=args.max_width,
                max_slope=args.max_slope, num_bands=args.num_bands,
                bottom_freedom=args.bottom_freedom, f_lower=args.f_lower,
                f_upper=args.f_upper, suffix=args.suffix, stream=stream,
                device=args.device))
        else:
            outs.extend(dropouts.process_max_mono(
                path, args.fft_size, args.fft_overlap, suffix=args.suffix,
                stream=stream, device=args.device))
    return outs


def _difeq(args):
    from .pipelines import difeq

    base = args.output[:-4] if args.output.endswith(".txt") else args.output
    _, _, paths = difeq.difeq_files(
        args.source, args.reference, base, channel_mode=args.channels,
        device=args.device, smoothing=args.smoothing, strength=args.strength,
        keep_gain=args.keep_gain, highpass=args.highpass,
        rolloff_start=args.rolloff_start, rolloff_end=args.rolloff_end)
    return paths


def _expand(args):
    from .pipelines import expander

    return [expander.expand_file(
        args.input, channel_mode=args.channels, band_lower=args.band_lower,
        band_upper=args.band_upper, clip_lower=args.clip_lower,
        clip_upper=args.clip_upper, smoothing_s=args.smoothing_s,
        transition=args.transition, order=args.order, suffix=args.suffix,
        stream=True if args.stream else "auto", device=args.device)]


def _humspeed(args):
    from .pipelines import humspeed

    matches = humspeed.analyze_hum(args.input, base_hum=args.base_hum,
                                   num_harmonies=args.harmonies,
                                   tolerance=args.tolerance, device=args.device)
    if args.analyze_only or not matches:
        return {"matches": matches}
    out = humspeed.resample_file(args.input, ratio=matches[-1]["ratio"],
                                 stream=True if args.stream else "auto",
                                 device=args.device)
    return {"matches": matches, "outputs": [out]}


def _pan(args):
    from .pipelines import pan
    from .utils import project

    proj = project.Project.load(args.project)
    return [pan.pan_file(args.input, proj.marker_list("markers"), device=args.device)]


def _renoise(args):
    from .pipelines import renoiser

    if args.preview:
        return {"preview": _renoise_preview(args, renoiser)}

    return [renoiser.process_file(
        args.input, noise_path=args.noise,
        selection=tuple(args.selection) if args.selection else None,
        gain=args.gain, overhead=args.overhead, fft_size=args.fft_size,
        fft_overlap=args.fft_overlap, suffix=args.suffix,
        stream=True if args.stream else "auto", device=args.device)]


def _hpss(args):
    from .pipelines import hpss_tool

    outs = []
    for path in args.inputs:
        outs.extend(hpss_tool.separate_file(
            path, args.fft_size, args.fft_overlap, args.kernel, args.power, args.margin,
            suffix=args.suffix, stream=True if args.stream else "auto",
            device=args.device))
    return outs


def _decompress(args):
    from .pipelines import decompressor

    return [decompressor.decompress_file(
        args.source, args.reference, stream=True if args.stream else "auto",
        device=args.device, hop=args.hop, sz=args.rms_size, lower=args.lower,
        upper=args.upper, smoothing_sec=args.smoothing, do_sync=args.sync)]


def _group_delay(args):
    from .pipelines import group_delay
    from .utils import audio_io

    ref, sr, _ = audio_io.read_file(args.reference)
    src, sr2, _ = audio_io.read_file(args.source)
    if sr != sr2:
        raise ValueError("Both files must have the same sample rate")
    bands = group_delay.band_delays(
        ref[:, 0], src[:, 0], sr, f_lower=args.lower, f_upper=args.upper,
        bandwidth=args.bandwidth, order=args.order, min_corr=args.min_corr,
        device=args.device)
    return {"sr": sr, "bands": bands}


def _cyclic_wow(args):
    import numpy as np

    from .pipelines import cyclic_wow
    from .utils import audio_io

    sig, sr, _ = audio_io.read_file(args.input)
    res = cyclic_wow.analyze(sig, sr, rpm=args.rpm, f0=args.f0, fft_size=args.fft_size,
                             tolerance=args.tolerance, device=args.device)
    curve = np.asarray(res.pop("cycle_curve"))
    res.pop("scan", None)
    if args.curve_out:
        np.savetxt(args.curve_out, 12.0 * (curve - np.mean(curve)))
        res["curve_out"] = args.curve_out
    return res


def _renoise_preview(args, renoiser):
    """The before/after masked-spectrogram figure (the re-mask-only path)."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    from .models import viz
    from .utils import audio_io

    signal, sr, _ = audio_io.read_file(args.input)
    pv = renoiser.RenoisePreview(signal, sr, args.fft_size, args.fft_overlap,
                                 device=args.device)
    if args.noise:
        profile = renoiser.noise_profile_from_file(args.noise, sr, args.fft_size,
                                                   args.fft_overlap, device=args.device)
    elif args.selection:
        profile = pv.noise_profile_from_selection(*args.selection)
    else:
        raise ValueError("preview needs --noise or --selection")
    masked = pv.remask(profile, args.gain, overhead=args.overhead)
    fig, axes = plt.subplots(2, 1, figsize=(12, 9))
    viz.plot_spectrogram(pv.magnitude(), sr, pv.hop, ax=axes[0], device=args.device)
    axes[0].set_title("original")
    viz.plot_spectrogram(masked, sr, pv.hop, ax=axes[1], device=args.device)
    axes[1].set_title(f"masked (gain {args.gain} dB)")
    fig.savefig(args.preview, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return args.preview


def _view(args):
    import os

    from .models import viz_html
    from .ops import fourier
    from .utils import audio_io

    sig, sr, _ = audio_io.read_file(args.input)
    hop = args.fft_size // args.fft_overlap
    mag = fourier.get_mag(sig[:, args.channel], args.fft_size, hop, zeropad=args.zeropad,
                          device=args.device)
    markers = []
    if args.trail:
        from .models import trackers

        pts = list(zip(args.trail[::2], args.trail[1::2]))
        times, freqs = trackers.trace("Peak", mag, sig, pts, args.fft_size * args.zeropad,
                                      hop, sr, device=args.device)
        markers.append({"t": list(times), "f": list(freqs)})
    out = args.output or (args.input.rsplit(".", 1)[0] + ".html")
    viz_html.save_interactive_html(out, mag, sr, hop, markers=markers,
                                   title=os.path.basename(args.input), cmap=args.cmap,
                                   device=args.device)
    return [out]


def _listen(args):
    import os

    from .models import audition
    from .utils import audio_io

    takes = []
    sr = None
    for path in args.inputs:
        sig, sr_i, _ = audio_io.read_file(path)
        if sr is None:
            sr = sr_i
        elif sr_i != sr:
            raise ValueError("all takes must share one sample rate")
        takes.append((os.path.basename(path), sig[int(args.start * sr):]))
    return [audition.save_audition_html(args.output, takes, sr,
                                        title=" vs ".join(n for n, _ in takes),
                                        max_seconds=args.seconds, device=args.device)]


def _measure(args):
    from .utils import metrics

    return metrics.measure_files(args.input, args.compare_to, args.metric,
                                 device=args.device)


def _bench(args):
    _not_ported("bench: the port's bench is ROADMAP queue 1 item 1")


def _doctor(args):
    from .utils.doctor import run_doctor

    return run_doctor(device_timeout_s=args.device_timeout, skip_device=args.no_device,
                      device=args.device)


def _not_ported(what: str):
    raise NotImplementedError(f"{what}; use python -m pyaudiorestoration_tpu")


if __name__ == "__main__":
    sys.exit(main())
