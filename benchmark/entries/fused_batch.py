"""Entry ``fused_batch``: a batch of independent mono takes of mixed length
a call through the program's ``restore_fused_takes`` with ``lengths``
(``respeed-batch --tier fused``'s traffic).

A call hands the entry the host float32 batch (B, N), each take padded
with zeros to the longest; the program uploads it, regenerates each take's
reflection past its end, tracks and plans each take and resamples the
whole batch in one pass, and the call ends when the (B, T, max_n) grids are
back in host memory.  A take's answer is its first ``length // hop``
segments, what the batch tier writes to its file."""

from __future__ import annotations

import torch


def prepare(params: dict, dev, pool):
    """The call of this entry for plan parameters ``params``, fixed at
    set-up (every batch of the pool has one shape)."""
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    B, N = pool[0]["x"].shape
    NL = torch.full((B, N // params["hop"] + 1), params["NL"], dtype=torch.int32, device=dev)
    NU = torch.full_like(NL, params["NU"])

    def call(item):
        out = rt.restore_fused_takes(
            item["x"], NL, NU, params["fft_size"], params["hop"], params["zeropad"],
            params["max_n"], nt=params["nt"], drift=params["drift"],
            window_name=params["window"], backend="auto", band=params["band"],
            lengths=item["lengths"], device=dev)
        return out.cpu().numpy()

    return call


def takes(item):
    """The takes (1, length) that a call restores."""
    return [item["x"][b:b + 1, :L] for b, L in enumerate(item["lengths"])]


def answers(item, out, params):
    """The grid (1, length // hop, max_n) of each take of :func:`takes`."""
    return [out[b:b + 1, :L // params["hop"]] for b, L in enumerate(item["lengths"])]
