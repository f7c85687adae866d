"""Pipeline ``file_fast``: ``respeed --fast`` from file to file.

The pool is the wow/flutter takes of ``lib/takes.py``, each written at
set-up as a 24-bit PCM WAV, the archival master format, by the standard
library's ``wave`` module (samples ``clip(round(x 2**23), -2**23,
2**23 - 1)``), into the run's directory of files.  The entry hands the
program the file's path; the program writes ``<take>_res.wav``.  An
answer is the stream that output file holds, read by ``scipy.io.wavfile``
after the window: the last answer of its pool item.  It is judged against
the file path's plain reference (``reference/file_restore.py``), which
probes each take for its own pilot tone as the program does, with the
numbers of ``reference/compare.py``.
"""

from __future__ import annotations

import wave

import numpy as np

from benchmark.lib import takes
from benchmark.reference import compare
from benchmark.reference.file_restore import FileReference

NUMBERS = compare.NUMBERS
FULL_SCALE = 1 << 23


def write_pcm24(path, x, sr: int) -> np.ndarray:
    """Write ``x`` (C, n) float32 as a 24-bit PCM WAV; returns the take as
    the file holds it, (C, n) float32 of the integers over 2**23."""
    q = np.clip(np.rint(x.astype(np.float64) * FULL_SCALE), -FULL_SCALE,
                FULL_SCALE - 1).astype("<i4")
    frames = np.ascontiguousarray(q.T).view(np.uint8).reshape(-1, 4)[:, :3]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(q.shape[0])
        w.setsampwidth(3)
        w.setframerate(sr)
        w.writeframes(frames.tobytes())
    return (q / FULL_SCALE).astype(np.float32)


def make_pool(cfg: dict, traffic: dict, seed: int, dev, files):
    """The traffic's pool, each item's take written to ``files/take<i>.wav``:
    ``x`` is the take as the file holds it, ``path`` the input file and
    ``out`` the output file the program writes beside it."""
    pool = takes.make_pool(cfg, traffic, seed, dev)
    files.mkdir(parents=True, exist_ok=True)
    for i, item in enumerate(pool):
        path = files / f"take{i}.wav"
        item["x"] = write_pcm24(path, item["x"], cfg["sample_rate"])
        item["path"], item["out"] = str(path), str(files / f"take{i}_res.wav")
    return pool


def params(pool: list, cfg: dict) -> dict:
    """The call's settings (``respeed --fast``'s flags from the
    configuration) and, for the log, the first take's probe and band; the
    reference probes each take itself (:func:`reference`)."""
    return {**takes.plan_params(pool[0]["x"][0], cfg), "cfg": cfg,
            "fft_overlap": cfg["fft_overlap"], "tolerance_st": 12.0 * cfg["band_octaves"],
            "sample_rate": cfg["sample_rate"]}


def reference(take, params: dict, dev, tf32_in: tuple = ()):
    """The file path's reference of ``take`` with its own probe and band."""
    return FileReference(take, takes.plan_params(take[0], params["cfg"]), dev, tf32_in=tf32_in)


def judge(stream, ref) -> dict:
    """The numbers of a written stream (C, L), or None where no file was
    written, against a :class:`FileReference` of the same take, as
    ``compare.judge`` gives them for a grid: the candidate centring whose
    stream lies nearest sample by sample is judged, the written stream
    split by that candidate's counts; samples that one stream has and the
    other lacks count at their full value."""
    C = ref.x.shape[0]
    if stream is None or stream.ndim != 2 or stream.shape[0] != C:
        return {k: float("inf") for k in NUMBERS}
    ps = [stream[c] for c in range(C)]
    gaps = [max(compare.stream_gap(p, ref.stream(cand, c)) for c, p in enumerate(ps))
            for cand in range(len(ref.plans))]
    cand = min(range(len(gaps)), key=lambda k: gaps[k][0])
    rs = [ref.stream(cand, c) for c in range(C)]
    m = min(len(ps[0]), len(rs[0]))
    resid, rms, timing = compare.aligned_gaps(
        [p[:m] for p in ps], [r[:m] for r in rs],
        [ref.stream(cand, c, slope=True)[:m] for c in range(C)], ref.counts(cand))
    if len(ps[0]) != len(rs[0]):
        resid = max(resid, *(float(np.max(np.abs(np.concatenate([p[m:], r[m:]])), initial=0.0))
                             for p, r in zip(ps, rs)))
    ref.streams.clear()
    return {"sample_gap": gaps[cand][0], "residual_gap": resid, "residual_rms": rms,
            "timing_gap": timing, "at": round(gaps[cand][1], 6), "centring": cand - 1,
            "length": len(ps[0]), "length_ref": len(rs[0])}


def work(ref) -> dict:
    """The sinc stage's inputs and real outputs of one take: every count
    of the plan, the samples past the end trim too, which the resample
    computes."""
    return {"inputs": int(ref.x.numel()), "outputs": int(ref.x.shape[0] * ref.counts().sum())}


def control(take, params: dict, dev, stages: tuple):
    """The reference computed with TF32 products in ``stages``, as the
    stream the program would write: a control that ``judge`` has to fail."""
    return reference(take, params, dev, tf32_in=stages).program_stream()
