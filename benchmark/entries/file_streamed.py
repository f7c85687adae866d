"""Entry ``file_streamed``: one take a call from file to file through the
program's ``restore_file_fast``, the body of ``respeed --fast``, on a file
past the configuration's ``stream_threshold_bytes``, so that the program
routes it to its two-pass streamed tier (``restore_file_streamed``).

The call is ``file_fast``'s, with ``stream="auto"`` and the
configuration's threshold, and the answers are read as ``file_fast``
reads them.  A call that the program did not hand to the streamed tier
(its ``respeeder.streamed`` counter did not advance by one) raises: the
cell measures that tier or fails, and never another path unseen.  The
configuration's ``frames_per_block`` and ``seg_tile`` state the tier's
defaults, which the router does not override; a program whose defaults
differ cannot run the cell."""

from __future__ import annotations

import contextlib
import inspect
import os
from pathlib import Path

from benchmark.lib import harness

_file_fast = harness.load_module(Path(__file__).resolve().parents[1], "entries", "file_fast")
takes = _file_fast.takes
answers = _file_fast.answers
TIER_KEYS = ("frames_per_block", "seg_tile")


def prepare(params: dict, dev, pool):
    """The call of this entry with ``respeed --fast``'s settings from
    ``params`` and the configuration's streaming threshold."""
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
    from pyaudiorestoration_tpu_torch.utils import timing

    cfg = params["cfg"]
    defaults = inspect.signature(rt.restore_file_streamed).parameters
    for key in TIER_KEYS:
        if defaults[key].default != cfg[key]:
            raise harness.CellError(f"the configuration's {key} is {cfg[key]}, the streamed "
                                    f"tier's default {defaults[key].default}")

    def streamed() -> int:
        return timing.counters().get("respeeder.streamed", 0)

    def call(item):
        with contextlib.suppress(FileNotFoundError):
            os.remove(item["out"])
        before = streamed()
        out = rt.restore_file_fast(
            item["path"], f0_hz=None, tolerance_st=params["tolerance_st"],
            fft_size=params["fft_size"], fft_overlap=params["fft_overlap"],
            zeropad=params["zeropad"], sinc_quality=params["nt"], stream="auto",
            stream_threshold_bytes=cfg["stream_threshold_bytes"], device=dev)
        if streamed() != before + 1:
            raise harness.CellError("the call did not go through restore_file_streamed")
        return out

    return call
