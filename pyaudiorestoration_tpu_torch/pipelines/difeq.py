"""Differential EQ (counterpart of pyaudiorestoration_tpu/pipelines/difeq.py;
reference tool: difeq_gui.py).

Average-spectrum difference ref - src, smoothed onto a log-spaced grid,
shaped by highpass / rolloff / strength / keep-gain parameters, exported as
an Audacity ``FilterCurve`` text file (difeq_gui.py:16-21, 212-266).  The
averaged spectra are computed on the device; the rest is host numpy.
"""

from __future__ import annotations

import numpy as np

from ..models.spectrum_flat import spectrum_from_audio_stereo
from ..ops import filters, fourier

__all__ = ["get_eq", "shape_eq", "write_eq_txt", "difeq_files"]


def get_eq(file_src, file_ref, channel_mode="L+R", fft_size=16384, hop=8192,
           device="cuda"):
    """Per-channel average-spectrum difference ref - src (difeq_gui.py:24-38).

    Returns (freqs, eq) with eq shape (2, n_freqs) in dB.
    """
    spectra_src, sr_src = spectrum_from_audio_stereo(file_src, fft_size, hop, channel_mode,
                                                     device=device)
    spectra_ref, sr_ref = spectrum_from_audio_stereo(file_ref, fft_size, hop, channel_mode,
                                                     device=device)
    freqs = fourier.fft_freqs(fft_size, sr_src)
    if sr_src != sr_ref:
        for i, spectrum in enumerate(spectra_ref):
            spectra_ref[i] = np.interp(freqs, fourier.fft_freqs(fft_size, sr_ref), spectrum)
    return freqs, np.asarray(spectra_ref) - np.asarray(spectra_src)


def shape_eq(freqs, eqs, smoothing=50, output_res=200, strength=1.0,
             keep_gain=False, highpass=0, rolloff_start=21000, rolloff_end=22000,
             num_in=2000):
    """Smooth, resample and shape the averaged EQ curves (difeq_gui.py:212-266).

    ``eqs``: list of (2, n_freqs) arrays (one per source/ref pair).
    Returns (freqs_av, av) with av shape (2, output_res-ish).
    """
    av_in = np.mean(np.asarray(eqs), axis=0)
    reduction_step = num_in // output_res
    # audacity EQ starts at 20 Hz; log2-spaced sampling grid
    freqs_spaced = np.power(2, np.linspace(np.log2(20), np.log2(freqs[-1]), num=num_in))
    freqs_av = filters.moving_average(freqs_spaced, n=smoothing)[::reduction_step]
    av = np.asarray([filters.moving_average(
        np.interp(freqs_spaced, freqs, av_in[channel]), n=smoothing)[::reduction_step]
        for channel in (0, 1)])
    # gain reference band 70 Hz .. rolloff_end
    idx1 = np.abs(freqs_av - 70).argmin()
    idx2 = np.abs(freqs_av - rolloff_end).argmin()
    gain = np.mean(av[:, idx1:idx2])
    if keep_gain:
        av = av - gain
    av = av * strength
    for channel in (0, 1):
        av[channel] *= np.interp(freqs_av, (rolloff_start, rolloff_end), (1, 0))
        av[channel] *= np.interp(freqs_av, (0, highpass), (0, 1)) if highpass else 1.0
    return freqs_av, av


def write_eq_txt(file_path, freqs, dB):
    """Audacity FilterCurve export (difeq_gui.py:16-21)."""
    with open(file_path, "w") as out:
        out.write('FilterCurve: FilterLength="8191" InterpolateLin="0" '
                  'InterpolationMethod="B-spline" ')
        for i, (f, d) in enumerate(zip(freqs, dB)):
            out.write(f'f{i}="{f}" ')
            out.write(f'v{i}="{d}" ')


def difeq_files(file_src, file_ref, out_base, channel_mode="L+R", device="cuda",
                **shape_kwargs):
    """BASELINE config 3: one-call differential EQ -> three FilterCurve files
    (mean, L, R).  Returns (freqs_av, av, paths)."""
    freqs, eq = get_eq(file_src, file_ref, channel_mode, device=device)
    freqs_av, av = shape_eq(freqs, [eq], **shape_kwargs)
    paths = []
    for suffix, curve in (("", np.mean(av, axis=0)), ("_L", av[0]), ("_R", av[1])):
        path = f"{out_base}{suffix}.txt"
        write_eq_txt(path, freqs_av, curve)
        paths.append(path)
    return freqs_av, av, paths
