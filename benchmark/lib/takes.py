"""The traffic generator: the pool of takes a cell's calls cycle through,
made from ``--seed`` as its configuration and traffic files say, and the
plan's parameters that the entries take at set-up.

The take is the port's wow/flutter recipe (``utils/synth.wow_take``:
an IEC 60386 pilot tone through a speed curve of wow and flutter, plus
white noise), frozen here so that a later change to the program's copy
cannot change the benchmark's input.  A seed draws each take's wow and
flutter phases and its noise; the sizes are the traffic file's whatever
the seed, so every seed asks the same work.  The takes are synthesized on
the device in float64 and handed to the program as host float32 arrays,
as a file read would give them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _take(n: int, sr: int, cfg: dict, phases, gen, dev):
    """(n,) float32 mono take on ``dev``."""
    t = torch.arange(n, dtype=torch.float64, device=dev) / sr
    w, f = cfg["wow"], cfg["flutter"]
    speed = (1.0 + w["depth"] * torch.sin(2 * math.pi * w["rate_hz"] * t + phases[0])
             + f["depth"] * torch.sin(2 * math.pi * f["rate_hz"] * t + phases[1]))
    del t
    phase = torch.cumsum(speed, 0).mul_(2 * math.pi * cfg["f0_hz"] / sr)
    del speed
    noise = torch.randn(n, generator=gen, dtype=torch.float64, device=dev)
    return (cfg["amplitude"] * torch.sin(phase) + cfg["noise"] * noise).to(torch.float32)


def make_pool(cfg: dict, traffic: dict, seed: int, dev) -> list:
    """The traffic's pool: ``traffic["pool"]`` items, each a dict with
    ``x`` (host float32: (C, n) for a take, (B, N) for a batch padded with
    zeros), ``lengths`` (each take's samples) and ``audio_s`` (the seconds
    of recorded audio a call restores)."""
    sr = cfg["sample_rate"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    lens = [int(round(s * sr)) for s in traffic["take_seconds"]]
    pool = []
    for i in range(traffic["pool"]):
        takes = []
        for j, n in enumerate(lens):
            gen.manual_seed(int(rng.integers(0, 2 ** 62)))
            phases = rng.uniform(0.0, 2 * math.pi, size=2)
            takes.append(_take(n, sr, cfg, phases, gen, dev))
        if traffic["layout"] == "batch":
            N = max(lens)
            x = torch.zeros((len(lens), N), dtype=torch.float32, device=dev)
            for j, take in enumerate(takes):
                x[j, :lens[j]] = take
            audio_s = sum(lens) / sr
        else:
            gains = torch.tensor(cfg["channel_gains"], dtype=torch.float32, device=dev)
            x = takes[0][None, :] * gains[:, None]
            audio_s = lens[0] / sr
        pool.append({"x": x.cpu().numpy(), "lengths": lens, "audio_s": audio_s})
        del takes, x
    return pool


def plan_params(mono, cfg: dict) -> dict:
    """The plan's parameters from a take's channel 0 (the port's
    ``bench.plan_params``, frozen): the pilot ``f0`` from the host rFFT of
    the first 2**18 samples under a Hann window; ``NL``/``NU``, the bins of
    f0 -+ ``cfg["band_octaves"]``; ``hop``, ``max_n = int(hop * 1.1)``,
    ``band = (NL - 1, NU + 1)``; and the configuration's sizes."""
    sr, fft, zeropad = cfg["sample_rate"], cfg["fft_size"], cfg["zeropad"]
    probe = np.asarray(mono[: 1 << 18])
    spec = np.abs(np.fft.rfft(probe * np.hanning(len(probe))))
    f0 = float(np.argmax(spec[10:]) + 10) / len(probe) * sr
    hop = fft // cfg["fft_overlap"]
    tol = cfg["band_octaves"]
    num_bins = fft * zeropad // 2 + 1
    NL = max(1, min(num_bins - 1, int(round(max(1.0, f0 * 2 ** -tol) * fft * zeropad / sr))))
    NU = max(1, min(num_bins - 1, int(round(min(sr / 2, f0 * 2 ** tol) * fft * zeropad / sr))))
    return {"f0": f0, "NL": NL, "NU": NU, "hop": hop, "max_n": int(hop * 1.1),
            "band": (NL - 1, NU + 1), "fft_size": fft, "zeropad": zeropad,
            "nt": cfg["sinc_quality"], "drift": cfg["drift"], "window": cfg["window"]}
