"""The port's ops/resampling against the JAX package's on the CPU: the host
position planners, sinc_resample's two branches (max |d| <= 3e-5, the
JAX tiers' bound), K1's plain version under the banded branch's argument
mapping against JAX's _sinc_banded_blocks, linear_resample, resample_ratio
and the batch entry run."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.ops import resampling as rj
from pyaudiorestoration_tpu.utils import audio_io
from pyaudiorestoration_tpu_torch.kernels import sinc_banded as kb
from pyaudiorestoration_tpu_torch.ops import resampling as rt

torch.set_num_threads(2)


def _wow_positions(n_in, depth=0.01, hop=256, sr=8000):
    t = np.arange(0, n_in + hop, hop, dtype=np.float64)
    speeds = 1.0 + depth * np.sin(2 * np.pi * 0.7 * t / sr)
    return t, speeds


@pytest.mark.parametrize("depth", [0.0, 0.01, 0.05])
def test_speed_to_pos_equal(depth):
    t, speeds = _wow_positions(20000, depth)
    assert np.array_equal(rt.speed_to_pos(t, speeds, 20000), rj.speed_to_pos(t, speeds, 20000))


def test_lag_to_pos_equal():
    t = np.linspace(0, 20000, 40)
    lags = 30 * np.sin(t / 3000.0) + 5
    assert np.array_equal(rt.lag_to_pos(t, lags, 20000), rj.lag_to_pos(t, lags, 20000))


@pytest.mark.parametrize("channels", [None, 2])
@pytest.mark.parametrize("kind", ["banded", "gather"])
def test_sinc_resample_matches_jax(channels, kind):
    rng = np.random.default_rng(7)
    n_in = 12000
    shape = (n_in,) if channels is None else (n_in, channels)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "banded":
        t, speeds = _wow_positions(n_in, 0.03)
        # a last block 502 long: JAX's drift check sees its padded tail too
        # (test_short_tail_block_stays_banded)
        pos = rj.speed_to_pos(t, speeds, n_in)[:23 * 512 - 10]
    else:  # a 2.7x ratio: every block drifts far past max_band_drift
        pos = np.arange(0, n_in - 1, 2.7)
    assert (rt.banded_layout(pos, rt._positions_to_device_args(pos)[2]) is None) == (
        kind == "gather")
    ref = rj.sinc_resample(x, pos, quality=16)
    got = rt.sinc_resample(x, pos, quality=16, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 3e-5
    dev_out = rt.sinc_resample(torch.from_numpy(x), pos, quality=16, device_out=True)
    assert isinstance(dev_out, torch.Tensor) and np.array_equal(dev_out.numpy(), got)


def test_short_tail_block_stays_banded():
    """A last output block shorter than block - max_band_drift sends the
    JAX package to its gather branch (its drift check counts the padded
    tail); the port stays banded, and equals JAX's banded branch."""
    n_in = 12000
    x = np.random.default_rng(7).standard_normal(n_in).astype(np.float32)
    t, speeds = _wow_positions(n_in, 0.03)
    pos = rj.speed_to_pos(t, speeds, n_in)  # 12002 outputs: a 226-sample tail
    assert rt.banded_layout(pos, rt._positions_to_device_args(pos)[2]) is not None
    ref = rj.sinc_resample(x, pos, quality=16, max_band_drift=1 << 12)
    assert np.abs(rt.sinc_resample(x, pos, quality=16, device="cpu") - ref).max() <= 3e-5


@pytest.mark.parametrize("nt,depth", [(8, 0.0), (16, 0.02), (50, 0.2)])
def test_k1_mapping_matches_sinc_banded_blocks(nt, depth, monkeypatch):
    """sinc_banded_plain (K1's plain version, which K1 is held to on the
    card) with base_int = anchors, bs = fc, rel, every lane valid and
    max_n = block reproduces JAX's _sinc_banded_blocks."""
    rng = np.random.default_rng(nt)
    n_in, block = 9000, 512
    sig = rng.standard_normal(n_in).astype(np.float32)
    t, speeds = _wow_positions(n_in, depth)
    pos = rj.speed_to_pos(t, speeds, n_in)
    _, _, fc = rj._positions_to_device_args(pos)
    anchors, rel, fc_b, drift = rt.banded_layout(pos, fc, block)
    ref = np.asarray(rj._sinc_banded_blocks(
        jnp.asarray(sig), jnp.asarray(anchors), jnp.asarray(rel), jnp.asarray(fc_b),
        nt, drift, block))
    got = kb.sinc_banded_plain(
        torch.from_numpy(sig), torch.from_numpy(anchors), torch.from_numpy(fc_b),
        torch.from_numpy(rel), torch.ones(rel.shape, dtype=torch.bool), nt, drift).numpy()
    assert np.abs(got - ref).max() <= 3e-5
    # the wrapper on a CPU tensor, chunked as the banded branch launches it
    monkeypatch.setattr(rt, "ROWS_PER_LAUNCH", 5)
    chunked = rt._sinc_banded_blocks(
        torch.from_numpy(sig), torch.from_numpy(anchors), torch.from_numpy(rel),
        torch.from_numpy(fc_b), nt, drift).numpy()
    assert np.array_equal(chunked, got)


@pytest.mark.parametrize("channels", [None, 3])
def test_linear_resample_matches_jax(channels):
    rng = np.random.default_rng(11)
    shape = (5000,) if channels is None else (5000, channels)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = np.concatenate([[-1.0, 0.0], np.sort(rng.uniform(0, 4999, 3000)), [4999.0, 5000.5]])
    np.testing.assert_allclose(rt.linear_resample(x, pos, device="cpu"),
                               rj.linear_resample(x, pos), atol=1e-5)


# lengths whose output is a whole number of 512-blocks, so that JAX's
# branch choice does not hinge on its padded tail (banded in the first two
# cases, gather in the third): at positions exactly halfway between samples
# the two branches centre their asymmetric 2*NT taps one sample apart
@pytest.mark.parametrize("sr_from,sr_to,axis,n", [(44100, 48000, 0, 3763),
                                                  (48000, 44100, 1, 4458),
                                                  (8000, 22050, 0, 4000)])
def test_resample_ratio_matches_jax(sr_from, sr_to, axis, n):
    x = np.random.default_rng(2).standard_normal((n, 2)).astype(np.float32)
    x = x if axis == 0 else np.ascontiguousarray(x.T)
    ref = rj.resample_ratio(x, sr_from, sr_to, quality=16, axis=axis)
    got = rt.resample_ratio(x, sr_from, sr_to, quality=16, axis=axis, device="cpu")
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 3e-5
    mono = rt.resample_ratio(x[:, 0] if axis == 0 else x[0], sr_from, sr_to, quality=16,
                             device="cpu")
    assert mono.shape == (ref.shape[axis],)


@pytest.mark.parametrize("mode", ["Sinc", "Linear"])
def test_run_writes_res_files(tmp_path, mode):
    sr = 8000
    x = np.random.default_rng(9).standard_normal((6000, 2)).astype(np.float32) * 0.1
    paths = []
    for name in ("a", "b"):
        paths.append(str(tmp_path / f"{name}.wav"))
        audio_io.write_wav(paths[-1], x, sr)
    curve = np.stack([np.linspace(0, 6000 / sr, 50),
                      1.0 + 0.01 * np.sin(np.linspace(0, 6, 50))], -1)
    ticks = []
    outs = rt.run(paths, speed_curve=curve, resampling_mode=mode, sinc_quality=16,
                  suffix="_t", prog_sig=ticks.append, device="cpu")
    assert outs == [p[:-4] + "_res_t.wav" for p in paths] and ticks[-1] == 100
    ref = rj.run([paths[0]], speed_curve=curve, resampling_mode=mode, sinc_quality=16,
                 suffix="_j")
    a, sr_a, ch = audio_io.read_file(outs[0])
    b, _, _ = audio_io.read_file(ref[0])
    assert sr_a == sr and ch == 2 and a.shape == b.shape
    assert np.abs(a - b).max() <= 3e-5
    lag = rt.run([paths[1]], lag_curve=np.stack([[0.0, 0.75], [0.002, 0.004]], -1),
                 resampling_mode=mode, suffix="_lag", device="cpu")
    assert os.path.isfile(lag[0])
    with pytest.raises(ValueError):
        rt.run([paths[0]], device="cpu")
