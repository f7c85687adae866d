"""The port's averaged spectra against the JAX package on the CPU: the
temporal means within 1e-3 dB for every channel mode (the mono fallback
included), the streamed means within 1e-3 dB of the in-memory ones
(tests/test_streaming_tools.py:202-217) and of JAX's streamed ones.  The
per-frame spectra (``temporal_mean=False``) hold 1e-3 dB within 60 dB of
each frame's peak; further down, two float32 FFTs differ by their rounding,
~1e-7 of the frame's peak, which is many dB at a deep bin, so there the
magnitudes hold 1e-6 of the frame's peak."""

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.models import spectrum_flat as sj
from pyaudiorestoration_tpu_torch.models import spectrum_flat as st
from pyaudiorestoration_tpu_torch.utils import audio_io as at

torch.set_num_threads(2)
SR = 22050
MODES = ["L", "R", "L+R", "Mean"]


def _stereo(tmp_path, seconds=3.0, seed=13, channels=2):
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    sig = np.sin(2 * np.pi * 880 * t) * 0.4 + rng.standard_normal(n) * 0.01
    x = np.stack([sig, 0.6 * sig + 0.02 * rng.standard_normal(n)], -1)[:, :channels]
    path = str(tmp_path / f"s{channels}.wav")
    at.write_wav(path, x.astype(np.float32), SR)
    return path


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("temporal_mean", [True, False])
def test_spectra_from_audio_matches_jax(tmp_path, mode, temporal_mean):
    path = _stereo(tmp_path)
    ref, sr_j = sj.spectra_from_audio(path, 2048, 512, mode, temporal_mean, stream=False)
    got, sr_t = st.spectra_from_audio(path, 2048, 512, mode, temporal_mean, stream=False,
                                      device="cpu")
    assert sr_t == sr_j == SR and len(got) == len(ref) == (2 if mode == "L+R" else 1)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        if temporal_mean:
            np.testing.assert_allclose(a, b, atol=1e-3)
            continue
        peak = b.max(axis=0, keepdims=True)
        loud = b > peak - 60
        assert loud.mean() > 0.3
        np.testing.assert_allclose(a[loud], b[loud], atol=1e-3)
        lin_a, lin_b = 10 ** (a / 20), 10 ** (b / 20)
        assert np.all(np.abs(lin_a - lin_b) <= 1e-6 * 10 ** (peak / 20))


@pytest.mark.parametrize("mode", ["L+R", "Mean", "R"])
def test_mono_fallback_matches_jax(tmp_path, mode):
    path = _stereo(tmp_path, channels=1)
    for stream in (False, True):
        ref, _ = sj.spectra_from_audio(path, 1024, 256, mode, stream=stream)
        got, _ = st.spectra_from_audio(path, 1024, 256, mode, stream=stream, device="cpu")
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, atol=1e-3)


@pytest.mark.parametrize("mode", ["L", "L+R", "Mean"])
def test_streamed_means_match_memory_and_jax(tmp_path, mode):
    path = _stereo(tmp_path, seconds=3.3)
    mem, _ = st.spectra_from_audio(path, 2048, 512, mode, stream=False, device="cpu")
    got, _ = st.spectra_from_audio(path, 2048, 512, mode, stream=True, device="cpu")
    ref, _ = sj.spectra_from_audio(path, 2048, 512, mode, stream=True)
    assert len(got) == len(mem) == len(ref)
    for a, b, c in zip(got, mem, ref):
        np.testing.assert_allclose(a, b, atol=1e-3)
        np.testing.assert_allclose(a, c, atol=1e-3)


def test_streamed_blocks_are_frame_exact(tmp_path):
    """Several blocks of the streamed mean sum to the one-block mean."""
    path = _stereo(tmp_path, seconds=2.0)
    one, _ = st._spectra_from_audio_streamed(path, 1024, 256, "L+R", device="cpu")
    many, _ = st._spectra_from_audio_streamed(path, 1024, 256, "L+R", block_frames=7,
                                              device="cpu")
    for a, b in zip(one, many):
        np.testing.assert_allclose(a, b, atol=1e-9)


@pytest.mark.parametrize("mode", ["L", "L+R"])
def test_spectrum_from_audio_and_stereo_match_jax(tmp_path, mode):
    path = _stereo(tmp_path)
    a, sr_a = st.spectrum_from_audio(path, 2048, 1024, mode, device="cpu")
    b, sr_b = sj.spectrum_from_audio(path, 2048, 1024, mode)
    assert sr_a == sr_b and a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=1e-3)
    a2, _ = st.spectrum_from_audio_stereo(path, 2048, 1024, mode, device="cpu")
    b2, _ = sj.spectrum_from_audio_stereo(path, 2048, 1024, mode)
    assert len(a2) == len(b2) == 2
    for x, y in zip(a2, b2):
        np.testing.assert_allclose(x, y, atol=1e-3)


def test_cuda_default_raises_without_a_card(tmp_path):
    path = _stereo(tmp_path, seconds=1.0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        st.spectra_from_audio(path)
