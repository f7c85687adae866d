"""The port's forward STFT against the JAX package's on the CPU
(tests/test_fourier.py's tolerance: atol 2e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.ops import fourier as fj
from pyaudiorestoration_tpu_torch.ops import fourier as ft

torch.set_num_threads(2)


@pytest.mark.parametrize("n_fft,step,zeropad,center", [
    (256, 64, 1, True), (512, 128, 2, True), (512, 96, 1, True),
    (256, 64, 4, False), (1024, 256, 1, True)])
@pytest.mark.parametrize("channels", [None, 2])
def test_stft_and_mag_match_jax(n_fft, step, zeropad, center, channels):
    rng = np.random.default_rng(n_fft + step)
    shape = (3000,) if channels is None else (channels, 3000)
    x = rng.standard_normal(shape).astype(np.float32)
    kw = dict(n_fft=n_fft, step=step, zeropad=zeropad, center=center)
    ref = np.asarray(fj.stft(jnp.asarray(x), **kw))
    got = ft.stft(x, device="cpu", **kw).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=2e-4)
    np.testing.assert_allclose(ft.get_mag(torch.from_numpy(x), **kw).numpy(),
                               np.asarray(fj.get_mag(jnp.asarray(x), **kw)), atol=2e-4)


def test_short_signal_reflects_again():
    """A pad longer than the signal repeats the reflection (jnp.pad), where
    F.pad refuses."""
    x = np.arange(5, dtype=np.float32)
    ref = np.asarray(fj.stft(jnp.asarray(x), n_fft=64, step=16))
    np.testing.assert_allclose(ft.stft(x, n_fft=64, step=16, device="cpu").numpy(),
                               ref, atol=2e-4)


@pytest.mark.parametrize("n,n_fft,step,center", [(1000, 256, 64, True),
                                                 (1000, 256, 64, False),
                                                 (100, 256, 128, False)])
def test_frame_helpers_match(n, n_fft, step, center):
    assert ft.n_frames_for(n, n_fft, step, center) == fj.n_frames_for(n, n_fft, step, center)
    np.testing.assert_array_equal(ft.fft_freqs(n_fft, 44100), fj.fft_freqs(n_fft, 44100))
    if ft.n_frames_for(n, n_fft, step, center):
        x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        np.testing.assert_array_equal(
            ft.frame_signal(torch.from_numpy(x), n_fft, step, center).numpy(),
            np.asarray(fj.frame_signal(jnp.asarray(x), n_fft, step, center)))
