"""Command-line interface of the PyTorch/CUDA port.

    python -m pyaudiorestoration_tpu_torch respeed --fast <audio> [--device cuda]

Only the ``respeed --fast`` path (the in-memory device pipeline) is ported;
its flags and defaults are those of ``pyaudiorestoration_tpu``'s ``respeed``.
The other respeed modes, ``--stream`` and ``.spd`` projects exit with a
"not ported yet" error.
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
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.input.endswith(".spd"):
        return _not_ported("respeed of a .spd project")
    if args.stream:
        return _not_ported("respeed --stream (the streamed tier)")
    if not args.fast:
        return _not_ported("respeed without --fast (the portable trackers)")
    from .pipelines import respeeder_device

    try:
        out = respeeder_device.restore_file_fast(
            args.input, f0_hz=args.f0, tolerance_st=args.tolerance,
            fft_size=args.fft_size, fft_overlap=args.fft_overlap,
            zeropad=args.zeropad, sinc_quality=args.sinc_quality,
            suffix=args.suffix, device=args.device)
    except NotImplementedError as e:
        print(f"error: not ported yet: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"outputs": [out]}))
    return 0


def _not_ported(what: str) -> int:
    print(f"error: {what} is not ported yet; use python -m pyaudiorestoration_tpu",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
