"""Entry ``fused_single``: one take a call through the program's
``restore_fused_device`` (the port's ``bench`` single tier).

A call hands the entry a host float32 take (C, n), as a file read gives
it; the entry uploads it (``torch.as_tensor`` inside the program), tracks
channel 0, plans and resamples every channel on the card, and the call
ends when the padded (C, T, max_n) grid is back in host memory."""

from __future__ import annotations

import torch


def prepare(params: dict, dev, pool):
    """The call of this entry for plan parameters ``params``, fixed at
    set-up as a user fixes the band once for a transfer (every take of the
    pool has one length)."""
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    n = pool[0]["x"].shape[-1]
    NL = torch.full((n // params["hop"] + 1,), params["NL"], dtype=torch.int32, device=dev)
    NU = torch.full_like(NL, params["NU"])

    def call(item):
        out = rt.restore_fused_device(
            item["x"], NL, NU, params["fft_size"], params["hop"], params["zeropad"],
            params["max_n"], nt=params["nt"], drift=params["drift"],
            window_name=params["window"], backend="auto", band=params["band"], device=dev)
        return out.cpu().numpy()

    return call


def takes(item):
    """The takes (C, n) that a call restores."""
    return [item["x"]]


def answers(item, out, params):
    """The grid (C, T, max_n) of each take of :func:`takes` in a call's output."""
    return [out]
