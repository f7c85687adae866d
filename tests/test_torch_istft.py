"""The port's inverse STFT and streamed masked-STFT engine against the JAX
package on the CPU: ``window_sumsquare`` bit-equal, ``istft`` and
``istft_frames_raw`` within 1e-6 on the same complex input (dividing hops, a
hop sharing a factor with n_fft, a coprime hop through the sequential
fallback, zeropad 2), ``virtual_read`` equal, and ``stream_masked_stft``
within 2e-7 of the port's in-memory round trip in the interior
(tests/test_streaming_tools.py:62) and 1e-5 of JAX's engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.ops import fourier as fj
from pyaudiorestoration_tpu.utils import audio_io as aj
from pyaudiorestoration_tpu.utils import streaming as sj
from pyaudiorestoration_tpu_torch.ops import fourier as ft
from pyaudiorestoration_tpu_torch.utils import audio_io as at
from pyaudiorestoration_tpu_torch.utils import streaming as st

torch.set_num_threads(2)
SR = 8000


def _spec(n, n_fft, hop, zeropad=1, window="blackmanharris", seed=0, channels=None):
    """A real signal's spectrum, made by the JAX package (complex64 numpy)."""
    rng = np.random.default_rng(seed)
    shape = (n,) if channels is None else (channels, n)
    x = rng.standard_normal(shape).astype(np.float32)
    return np.asarray(fj.stft(jnp.asarray(x), n_fft=n_fft, step=hop, window_name=window,
                              zeropad=zeropad)), x


@pytest.mark.parametrize("window,n_frames,hop,win_length,n_fft", [
    ("blackmanharris", 40, 128, None, 512), ("hann", 33, 129, None, 512),
    ("hann", 10, 64, 200, 256), ("blackmanharris", 1, 32, None, 512)])
def test_window_sumsquare_bit_equal(window, n_frames, hop, win_length, n_fft):
    got = ft.window_sumsquare(window, n_frames, hop, win_length, n_fft)
    ref = fj.window_sumsquare(window, n_frames, hop, win_length, n_fft)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_fft,hop,zeropad,window", [
    (512, 128, 1, "blackmanharris"),   # dividing hop
    (512, 32, 1, "blackmanharris"),    # heal's overlap 16
    (256, 64, 2, "hann"),              # zeropad 2
    (512, 160, 1, "hann"),             # gcd 32: hb 5 spread
    (512, 129, 1, "hann"),             # coprime: the sequential fallback
])
@pytest.mark.parametrize("length,center", [(None, True), (3001, True), (2500, False)])
def test_istft_matches_jax(n_fft, hop, zeropad, window, length, center):
    spec, _ = _spec(3000, n_fft, hop, zeropad, window, seed=hop)
    kw = dict(hop_length=hop, window_name=window, center=center, length=length,
              zeropad=zeropad)
    ref = np.asarray(fj.istft(jnp.asarray(spec), **kw))
    got = ft.istft(spec, device="cpu", **kw).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    if not center:
        # the uncentred ends divide by the envelope's rise from ~0
        # (blackmanharris starts at 6e-5), which magnifies any ulp of the
        # irfft: compare where the envelope is over a tenth of its peak
        env = ft.window_sumsquare(window, spec.shape[-1], hop, None, n_fft)[:len(got)]
        keep = env > 0.1 * env.max()
        got, ref = got[keep], ref[keep]
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_istft_batched_rows_match_single_rows():
    spec, x = _spec(4000, 512, 32, channels=2, seed=7)
    got = ft.istft(torch.from_numpy(spec), hop_length=32, length=4000)
    for c in range(2):
        row = ft.istft(torch.from_numpy(spec[c]), hop_length=32, length=4000)
        np.testing.assert_allclose(got[c].numpy(), row.numpy(), atol=1e-6)
        np.testing.assert_allclose(got[c].numpy(), x[c], atol=1e-4)  # round trip


@pytest.mark.parametrize("n_fft,hop,zeropad", [(512, 32, 1), (256, 64, 2), (512, 129, 1)])
@pytest.mark.parametrize("channels", [None, 2])
def test_istft_frames_raw_matches_jax(n_fft, hop, zeropad, channels):
    spec, _ = _spec(2000, n_fft, hop, zeropad, seed=n_fft + hop, channels=channels)
    ref = np.asarray(fj.istft_frames_raw(jnp.asarray(spec), hop, "blackmanharris",
                                         zeropad))
    got = ft.istft_frames_raw(torch.from_numpy(spec), hop, "blackmanharris",
                              zeropad).numpy()
    assert got.shape == ref.shape
    # unnormalised, the sum of n_fft / hop frames: compare it divided by its
    # envelope, as the streamed engine uses it, where the envelope is over a
    # tenth of its peak (see test_istft_matches_jax)
    env = ft.window_sumsquare("blackmanharris", spec.shape[-1], hop, None,
                              2 * (spec.shape[-2] - 1) // zeropad)
    keep = env > 0.1 * env.max()
    np.testing.assert_allclose(got[..., keep] / env[keep], ref[..., keep] / env[keep],
                               atol=1e-6)


@pytest.mark.parametrize("n_frames,n_fft,hop", [(50, 512, 128), (50, 512, 160),
                                                (20, 256, 96), (30, 512, 129)])
def test_overlap_add_matches_jax(n_frames, n_fft, hop):
    frames = np.random.default_rng(hop).standard_normal((n_frames, n_fft)).astype(
        np.float32)
    out_len = (n_frames - 1) * hop + n_fft
    ref = np.asarray(fj._overlap_add(jnp.asarray(frames), hop, out_len))
    got = ft._overlap_add(torch.from_numpy(frames), hop, out_len).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_fix_length_and_pad_center():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    for size, axis in ((6, -1), (2, -1), (4, 0), (2, 0), (4, 1)):
        ref = np.asarray(fj.fix_length(x, size, axis=axis))
        np.testing.assert_array_equal(ft.fix_length(x, size, axis=axis), ref)
        np.testing.assert_array_equal(
            ft.fix_length(torch.from_numpy(x), size, axis=axis).numpy(), ref)
    np.testing.assert_array_equal(ft.pad_center(np.ones(5), 9), fj.pad_center(np.ones(5), 9))
    with pytest.raises(ValueError):
        ft.pad_center(np.ones(5), 4)


def _noisy_tone(n, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    sig = np.sin(2 * np.pi * 440 * t) * 0.4 + rng.standard_normal(n) * 0.01
    return np.stack([sig, 0.6 * sig], -1).astype(np.float32)


@pytest.mark.parametrize("a,b,pad", [(-300, 500, 256), (15800, 16700, 256),
                                     (0, 16000, 0), (-1000, 17500, 256)])
def test_virtual_read_equal(tmp_path, a, b, pad):
    p = str(tmp_path / "v.wav")
    aj.write_wav(p, _noisy_tone(16000), SR)
    with aj.StreamReader(p) as rj, at.StreamReader(p) as rt:
        for chans in ([0, 1], [1]):
            np.testing.assert_array_equal(st.virtual_read(rt, a, b, pad, chans),
                                          sj.virtual_read(rj, a, b, pad, chans))


def _gain_curve(n_bins):
    """A per-bin gain, as renoise's mask: local in time, so the streamed and
    in-memory round trips agree in the interior."""
    return (0.2 + np.abs(np.sin(np.arange(n_bins) / 7.0))).astype(np.float32)[:, None]


@pytest.mark.parametrize("fft_size,hop,block_frames", [(512, 128, 64), (512, 32, 200)])
def test_stream_masked_stft_matches_memory_and_jax(tmp_path, fft_size, hop, block_frames):
    n = int(2.3 * SR)
    x = _noisy_tone(n, seed=fft_size + hop)
    p = str(tmp_path / "in.wav")
    at.write_wav(p, x, SR)
    g = _gain_curve(fft_size // 2 + 1)
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    st.stream_masked_stft(p, out_t, lambda s, t0: torch.from_numpy(g), fft_size, hop,
                          block_frames=block_frames, device="cpu")
    sj.stream_masked_stft(p, out_j, lambda s, t0: jnp.asarray(g), fft_size, hop,
                          block_frames=block_frames)
    got, _, _ = at.read_file(out_t)
    ref, _, _ = aj.read_file(out_j)
    # the port's in-memory round trip: stft(fix_length(x, n+pad)) -> mask -> istft
    y_pad = ft.fix_length(x, n + fft_size // 2, axis=0)
    spec = ft.stft(np.ascontiguousarray(y_pad.T), n_fft=fft_size, step=hop, device="cpu")
    mem = ft.istft(spec * torch.from_numpy(g), length=n, hop_length=hop).numpy().T
    assert got.shape == ref.shape == mem.shape == x.shape
    h = fft_size * 2
    np.testing.assert_allclose(got[h:-h], mem[h:-h], atol=2e-7)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_stream_masked_stft_multi_output_mix_down(tmp_path):
    """N output files from N factor sets in one pass; ``mix_down`` sums the
    masked channels (tests/test_streaming_tools.py:160-175)."""
    x = _noisy_tone(2 * SR)
    p = str(tmp_path / "in.wav")
    at.write_wav(p, x, SR)
    outs = [str(tmp_path / "h.wav"), str(tmp_path / "q.wav")]
    st.stream_masked_stft(p, outs, lambda s, t0: [torch.ones(()), torch.full((), 0.5)],
                          1024, 256, [0, 1], device="cpu")
    a, _, _ = at.read_file(outs[0])
    b, _, _ = at.read_file(outs[1])
    np.testing.assert_allclose(b, 0.5 * a, atol=1e-7)
    np.testing.assert_allclose(a[1024:-1024], x[1024:-1024], atol=1e-5)
    mono = str(tmp_path / "m.wav")
    st.stream_masked_stft(p, mono, lambda s, t0: torch.ones(()), 1024, 256,
                          mix_down=True, device="cpu")
    m, _, ch = at.read_file(mono)
    assert ch == 1
    np.testing.assert_allclose(m[1024:-1024, 0], x[1024:-1024].sum(-1), atol=1e-5)


def test_stream_process_trims_halos():
    x = np.random.default_rng(2).standard_normal(10_000).astype(np.float32)
    ref = sj.stream_process(x, lambda b: 2 * b, 64, blocksize=16, overlap=8)
    got = st.stream_process(x, lambda b: torch.from_numpy(2 * b), 64, blocksize=16,
                            overlap=8)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, 2 * x)


def test_stream_masked_stft_needs_a_card_for_cuda(tmp_path):
    p = str(tmp_path / "in.wav")
    at.write_wav(p, _noisy_tone(SR), SR)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        st.stream_masked_stft(p, str(tmp_path / "o.wav"), lambda s, t0: 1.0, 512, 128)
