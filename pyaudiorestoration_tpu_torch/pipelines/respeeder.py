"""Wow & flutter removal, the portable path (counterpart of
pyaudiorestoration_tpu/pipelines/respeeder.py; reference tool:
pyrespeeder_gui.py).

    spectrogram (device) -> tracker(trail) -> TraceLine markers (host)
    -> master speed curve (host float64) -> speed_to_pos (host float64)
    -> windowed-sinc resample (K1 on the card) -> write

The spectrogram is downloaded as numpy, as in the JAX package, and each
tracker uploads the slice it needs.  ``.spd`` projects replay the saved
markers (``run_project``), in memory or through the streamed tier.  Every
entry takes ``device`` ("cuda" by default).
"""

from __future__ import annotations

import logging

import numpy as np

from ..models import markers as mk
from ..models import trackers
from ..ops import fourier, resampling
from ..utils import audio_io, project, streaming

DEFAULT_BANDS = (0, 9999999)


def compute_spectrum(signal, sr, fft_size=1024, fft_overlap=4, zeropad=1, channel=0,
                     device="cuda"):
    """Magnitude spectrogram of one channel, reference conventions: numpy
    (n_freqs, n_frames), stored frame-major (the device's layout, so the
    download and the trackers' upload copy nothing)."""
    hop = fft_size // fft_overlap
    sig = signal[:, channel] if signal.ndim == 2 else signal
    mag = fourier.get_mag(np.ascontiguousarray(sig), fft_size, hop, zeropad=zeropad,
                          device=device).cpu().numpy()
    return mag, hop


def trace_trail(signal, sr, trail, mode="Peak", fft_size=1024, fft_overlap=4,
                zeropad=1, tolerance=1.0, adapt="None", channel=0,
                other_lines=(), auto_align=False, spectrum=None, device="cuda"):
    """Run a tracker over a drawn trail -> TraceLine (pyrespeeder_gui.py:165-200).
    The tracker's bins become Hz through ``fft_size * zeropad``."""
    hop = fft_size // fft_overlap
    if spectrum is None:
        spectrum, hop = compute_spectrum(signal, sr, fft_size, fft_overlap, zeropad,
                                         channel, device=device)
    times, freqs = trackers.trace(
        mode, spectrum, signal if signal.ndim == 2 else signal[:, None], trail,
        fft_size * zeropad, hop, sr, tolerance, adapt, device=device)
    return mk.TraceLine(times, freqs, auto_align=auto_align, other_lines=other_lines)


def get_speed_curve(lines, regs, sr, hop, duration, bands=DEFAULT_BANDS):
    """Master speed curve: regressions beat raw traces if present
    (pyrespeeder_gui.py:133-140)."""
    if regs:
        master = mk.MasterRegLine(sr, hop, duration, bands)
        logging.info("Using regressed speed")
        return master.get_linspace(regs)
    master = mk.MasterSpeedLine(sr, hop, duration, bands)
    logging.info("Using measured speed")
    return master.get_linspace(lines)


def merge_traces(lines_to_merge, master_speed_data, sr, hop):
    """Merge overlapping traces into one line via the master curve
    (pyrespeeder_gui.py:95-117).  Returns a new TraceLine."""
    t0 = min(tr.times[0] for tr in lines_to_merge)
    t1 = max(tr.times[-1] for tr in lines_to_merge)
    means = [tr.spec_center[1] for tr in lines_to_merge]
    i0 = int(t0 * sr / hop)
    i1 = int(t1 * sr / hop)
    data = master_speed_data[i0:i1]
    freqs = np.power(2, data[:, 1] + np.log2(np.mean(means)))
    # at construction time the canvas still contains the traces being merged,
    # so the new line auto-aligns against them (pyrespeeder_gui.py:109-110)
    return mk.TraceLine(data[:, 0], freqs, offset=None, auto_align=True,
                        other_lines=list(lines_to_merge))


def respeed(filenames, lines=(), regs=(), sr=None, hop=None, duration=None,
            bands=DEFAULT_BANDS, resampling_mode="Sinc", sinc_quality=50,
            use_channels=(), suffix="", signal_data=None, device="cuda"):
    """Resample files through the master speed curve (the tool's export path,
    pyrespeeder_gui.py:119-159).  Returns output paths."""
    speed_curve = get_speed_curve(list(lines), list(regs), sr, hop, duration, bands)
    return resampling.run(
        filenames, signal_data=signal_data, speed_curve=speed_curve,
        resampling_mode=resampling_mode, sinc_quality=sinc_quality,
        use_channels=use_channels, suffix=suffix, device=device)


def run_project(project_path, audio_path=None, out_suffix="", stream="auto",
                stream_threshold_bytes: int = 1 << 30, device="cuda"):
    """Execute a ``.spd`` project headlessly: load markers, resample source.

    ``stream``: larger-than-memory replay -- the master curve (frame-rate
    host math from the markers, no audio decode required) drives the
    two-pass streamed restore through its ``speed_curve`` override."""
    proj = project.Project.load(project_path)
    audio_path = audio_path or proj.settings.get("source") or proj.settings.get("reference")
    if streaming.should_stream(audio_path, stream, stream_threshold_bytes):
        from . import respeeder_device as rdev

        fft_size = proj.fft_size
        hop = proj.hop
        with audio_io.StreamReader(audio_path) as r:
            sr = r.sample_rate
            n = int(r.frames)
        duration = n / sr
        curve = get_speed_curve(proj.marker_list("lines"),
                                proj.marker_list("regs"), sr, hop, duration)
        n_frames = (n + 2 * (fft_size // 2) - fft_size) // hop + 1
        t_frames = np.arange(n_frames) * hop / sr
        # get_speed_curve already returns LINEAR factors (get_linspace)
        speeds = np.interp(t_frames, curve[:, 0], curve[:, 1])
        out = rdev.restore_file_streamed(
            audio_path, fft_size=fft_size, fft_overlap=fft_size // hop,
            sinc_quality=int(proj.settings.get("sinc_quality", 50)),
            suffix=out_suffix or proj.settings.get("suffix", ""),
            speed_curve=speeds, device=device)
        return [out]
    signal, sr, channels = audio_io.read_file(audio_path)
    duration = len(signal) / sr
    return respeed(
        (audio_path,), lines=proj.marker_list("lines"), regs=proj.marker_list("regs"),
        sr=sr, hop=proj.hop, duration=duration,
        resampling_mode=proj.settings.get("resampling_mode", "Sinc"),
        sinc_quality=int(proj.settings.get("sinc_quality", 50)),
        suffix=out_suffix or proj.settings.get("suffix", ""),
        signal_data=((signal, sr),) if audio_path else None, device=device)


def restore_file(audio_path, mode="Peak", fft_size=1024, fft_overlap=4, zeropad=1,
                 tolerance=1.0, trail=None, resampling_mode="Sinc", sinc_quality=50,
                 suffix="", bands=DEFAULT_BANDS, save_project=False, adapt="None",
                 blockwise: int = 0, device="cuda"):
    """One-shot wow/flutter fix: trace the strongest tone and resample.

    If no trail is given, seed the tracker with the loudest stable frequency
    (the autopilot path for pilot-tone / music material).

    ``blockwise``: trace in blocks of this many FFT frames with halo trim
    (the shared ``streaming.stream_trace``, the reference's blockwise
    pattern, experiments/pyrespeeder_cmd.py:16-49) so the spectrogram never
    materializes whole; 0 traces the whole take at once.
    """
    signal, sr, channels = audio_io.read_file(audio_path)
    duration = len(signal) / sr
    hop = fft_size // fft_overlap
    if blockwise:
        if trail is None:
            probe, _ = compute_spectrum(signal[: min(len(signal), 1 << 20)],
                                        sr, fft_size, fft_overlap, zeropad,
                                        device=device)
            peak_bin = int(np.argmax(probe.mean(axis=1)[1:])) + 1
            f0 = peak_bin / (fft_size * zeropad) * sr
            logging.info(f"Auto trail at {f0:.1f} Hz (blockwise)")
        else:
            f0 = float(np.mean([f for _, f in trail]))

        def block_tracker(block, sr_):
            b_dur = len(block) / sr_
            tl = trace_trail(block, sr_, [(0.0, f0), (b_dur, f0)], mode,
                             fft_size, fft_overlap, zeropad, tolerance,
                             adapt=adapt, device=device)
            return tl.times, tl.freqs

        times, freqs = streaming.stream_trace(signal, sr, block_tracker,
                                              fft_size, hop,
                                              blocksize=int(blockwise))
        line = mk.TraceLine(times, freqs)
    else:
        spectrum, hop = compute_spectrum(signal, sr, fft_size, fft_overlap,
                                         zeropad, device=device)
        if trail is None:
            mean_spec = spectrum.mean(axis=1)
            peak_bin = int(np.argmax(mean_spec[1:])) + 1
            f0 = peak_bin / (fft_size * zeropad) * sr
            trail = [(0.0, f0), (duration, f0)]
            logging.info(f"Auto trail at {f0:.1f} Hz")
        line = trace_trail(signal, sr, trail, mode, fft_size, fft_overlap,
                           zeropad, tolerance, adapt=adapt, spectrum=spectrum,
                           device=device)
    if save_project:
        # GUI Save parity: markers + visible settings (widgets.py:1224-1234)
        proj = project.Project(".spd", {
            "source": audio_path, "fft_size": fft_size, "fft_overlap": fft_overlap,
            "fft_zeropad": zeropad, "mode": mode, "tolerance": tolerance,
            "resampling_mode": resampling_mode, "sinc_quality": sinc_quality,
            "suffix": suffix,
        }, {"lines": [line], "regs": []})
        proj.save(project.project_path_for(audio_path, ".spd"))
    return respeed((audio_path,), lines=[line], sr=sr, hop=hop, duration=duration,
                   bands=bands, resampling_mode=resampling_mode,
                   sinc_quality=sinc_quality, suffix=suffix,
                   signal_data=((signal, sr),), device=device)
