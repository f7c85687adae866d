"""Command-line interface of the PyTorch/CUDA port.

    python -m pyaudiorestoration_tpu_torch respeed --fast <audio> [--device cuda]
    python -m pyaudiorestoration_tpu_torch respeed-batch <audio>... [--device cuda]

Ported: ``respeed --fast`` (the in-memory device pipeline) and
``respeed-batch --tier fused`` (independent takes on one card), with the
flags and defaults of ``pyaudiorestoration_tpu``'s subcommands plus
``--device``.  The other respeed modes, ``--stream``, ``.spd`` projects and
``respeed-batch --tier fixed`` exit with a "not ported yet" error.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="pyaudiorestoration_tpu_torch",
                                description="audio restoration on PyTorch/CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("respeed", help="wow & flutter removal (pyrespeeder)")
    sp.add_argument("input", help="audio file")
    sp.add_argument("--fft-size", type=int, default=1024)
    sp.add_argument("--fft-overlap", type=int, default=8)
    sp.add_argument("--zeropad", type=int, default=4)
    sp.add_argument("--tolerance", type=float, default=1.0)
    sp.add_argument("--sinc-quality", type=int, default=50)
    sp.add_argument("--suffix", default="")
    sp.add_argument("--fast", action="store_true",
                    help="device-resident pipeline (auto pilot-tone tracking)")
    sp.add_argument("--stream", action="store_true",
                    help="two-pass streamed restore (not ported yet)")
    sp.add_argument("--f0", type=float, default=None,
                    help="target frequency for --fast tracking")
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
    run = _respeed_batch if args.cmd == "respeed-batch" else _respeed
    try:
        outs = run(args)
    except NotImplementedError as e:
        print(f"error: not ported yet: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"outputs": outs}))
    return 0


def _respeed(args):
    if args.input.endswith(".spd"):
        _not_ported("respeed of a .spd project")
    if args.stream:
        _not_ported("respeed --stream (the streamed tier)")
    if not args.fast:
        _not_ported("respeed without --fast (the portable trackers)")
    from .pipelines import respeeder_device

    return [respeeder_device.restore_file_fast(
        args.input, f0_hz=args.f0, tolerance_st=args.tolerance,
        fft_size=args.fft_size, fft_overlap=args.fft_overlap,
        zeropad=args.zeropad, sinc_quality=args.sinc_quality,
        suffix=args.suffix, device=args.device)]


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
