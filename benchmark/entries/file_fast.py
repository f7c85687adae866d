"""Entry ``file_fast``: one take a call from file to file through the
program's ``restore_file_fast``, the body of ``respeed --fast`` with no
``--f0`` (the ``file_fast`` pipeline's traffic).

A call removes the item's output file, so that a call that writes nothing
leaves nothing to judge, and hands the program the input file's path: it
reads the file with its native codec, probes the pilot tone on the host,
uploads the take, tracks, plans on the host in float64, resamples and
compacts on the card, downloads the stream and writes the float32 WAV
``<take>_res.wav``.  The call ends when the writer has closed the file,
and returns its path."""

from __future__ import annotations

import contextlib
import os

import numpy as np


def prepare(params: dict, dev, pool):
    """The call of this entry with ``respeed --fast``'s settings from
    ``params``."""
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    def call(item):
        with contextlib.suppress(FileNotFoundError):
            os.remove(item["out"])
        return rt.restore_file_fast(
            item["path"], f0_hz=None, tolerance_st=params["tolerance_st"],
            fft_size=params["fft_size"], fft_overlap=params["fft_overlap"],
            zeropad=params["zeropad"], sinc_quality=params["nt"], stream="auto", device=dev)

    return call


def takes(item):
    """The take (C, n) that a call restores, as its input file holds it."""
    return [item["x"]]


def answers(item, out, params):
    """The stream (C, L) float32 that the item's output file holds, read by
    ``scipy.io.wavfile``; None where there is no file, or it is not a
    float32 WAV at the take's rate."""
    from scipy.io import wavfile

    if not os.path.isfile(item["out"]):
        return [None]
    sr, data = wavfile.read(item["out"])
    if sr != params["sample_rate"] or data.dtype != np.float32:
        return [None]
    return [np.ascontiguousarray((data[:, None] if data.ndim == 1 else data).T)]
