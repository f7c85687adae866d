"""Command-line interface of the PyTorch/CUDA port.

    python -m pyaudiorestoration_tpu_torch respeed <audio|project.spd> [...] [--device cuda]
    python -m pyaudiorestoration_tpu_torch respeed-batch <audio>... [--device cuda]

``respeed`` has every form of ``pyaudiorestoration_tpu``'s subcommand, with
its flags and defaults plus ``--device``: the portable trackers (``--mode``,
``--trail``, ``--adaptation``, ``--resampling-mode``, ``--save-project``),
``.spd`` project replay, the device pipeline (``--fast``) and the streamed
two-pass tier (``--stream``, or automatically for takes over 1 GiB
decoded).  ``respeed-batch --tier fused`` restores independent takes on one
card; ``--tier fixed`` exits with a "not ported yet" error.  The global
``--flac-out [BITS]`` / ``--flac-fast`` write FLAC instead of float WAV.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
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
    sp.add_argument("--fft-size", type=int, default=1024)
    sp.add_argument("--fft-overlap", type=int, default=8)
    sp.add_argument("--zeropad", type=int, default=4)
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
    sp.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")

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
                         "fixed = the fixed-length linear tier (not ported yet)")
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--zeropad", type=int, default=1)
    sp.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.flac_out is not None:
        from .utils import audio_io

        audio_io.set_output_format("flac", bits=args.flac_out,
                                   level=0 if args.flac_fast else 1)
    run = _respeed_batch if args.cmd == "respeed-batch" else _respeed
    try:
        outs = run(args)
    except NotImplementedError as e:
        print(f"error: not ported yet: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"outputs": outs}))
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
    if args.tier == "fixed":
        _not_ported("respeed-batch --tier fixed (the fixed-length tier)")
    from .parallel import batch

    return batch.restore_batch_files_fused(
        args.inputs, args.f0, fft_size=args.fft_size,
        fft_overlap=max(1, args.fft_size // args.step), zeropad=args.zeropad,
        sinc_quality=args.sinc_quality, device=args.device)


def _not_ported(what: str):
    raise NotImplementedError(f"{what}; use python -m pyaudiorestoration_tpu")


if __name__ == "__main__":
    sys.exit(main())
