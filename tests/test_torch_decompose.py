"""The port's HPSS building blocks against the JAX package on the CPU: the
median filter exactly equal to JAX's (and to scipy's 'reflect' median),
batched over channels, tiled or not, with pads longer than the axis; the
soft and hard masks, ``magphase`` and ``hpss`` within 1e-5
(tests/test_decompose.py's tolerance), batched (C, F, T) equal to one
channel at a time."""

import numpy as np
import pytest
import torch
from scipy.ndimage import median_filter

from pyaudiorestoration_tpu.ops import decompose as dj
from pyaudiorestoration_tpu_torch.ops import decompose as dt

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("size,axis,block", [(31, 1, 32), (31, 0, 32), (5, 1, 128),
                                             (17, 0, 7), (3, 1, 1)])
def test_median_filter_equals_jax_and_scipy(size, axis, block):
    x = np.random.default_rng(1).standard_normal((70, 90)).astype(np.float32)
    got = dt.median_filter_1d(_t(x), size, axis=axis, block=block).numpy()
    ref = np.asarray(dj.median_filter_1d(x, size, axis=axis, block=32))
    np.testing.assert_array_equal(got, ref)
    scipy_size = (1, size) if axis == 1 else (size, 1)
    np.testing.assert_array_equal(got, median_filter(x, size=scipy_size, mode="reflect"))


def test_median_filter_pads_longer_than_the_axis():
    """A kernel wider than twice the axis: numpy's symmetric pad repeats
    with period 2n; F.pad refuses pads this long."""
    x = np.random.default_rng(2).standard_normal((4, 6)).astype(np.float32)
    got = dt.median_filter_1d(_t(x), 31, axis=1).numpy()
    np.testing.assert_array_equal(got, np.asarray(dj.median_filter_1d(x, 31, axis=1)))
    pad = dt._symmetric_pad(_t(x), 15, 15).numpy()
    np.testing.assert_array_equal(pad, np.pad(x, ((0, 0), (15, 15)), mode="symmetric"))


@pytest.mark.parametrize("axis", [-1, -2])
def test_median_filter_batched_equals_per_channel(axis):
    x = np.random.default_rng(3).standard_normal((3, 40, 50)).astype(np.float32)
    got = dt.median_filter_1d(_t(x), 9, axis=axis, block=16).numpy()
    for c in range(3):
        ref = np.asarray(dj.median_filter_1d(x[c], 9, axis=axis % 2))
        np.testing.assert_array_equal(got[c], ref)


def test_median_filter_rejects_even_kernels():
    with pytest.raises(ValueError, match="odd"):
        dt.median_filter_1d(torch.zeros(4, 4), 4, axis=1)


@pytest.mark.parametrize("power,split_zeros", [(1, False), (2, False), (2.0, True),
                                               (np.inf, False)])
def test_softmask_matches_jax(power, split_zeros):
    rng = np.random.default_rng(4)
    X = np.abs(rng.standard_normal((20, 30))).astype(np.float32)
    R = np.abs(rng.standard_normal((20, 30))).astype(np.float32)
    X[0, :5] = 0.0
    R[0, :5] = 0.0  # Z below tiny: the fill
    got = dt.softmask(_t(X), _t(R), power=power, split_zeros=split_zeros).numpy()
    ref = np.asarray(dj.softmask(X, R, power=power, split_zeros=split_zeros))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if not np.isinf(power):
        assert np.all(got[0, :5] == (0.5 if split_zeros else 0.0))
    with pytest.raises(ValueError, match="Shape mismatch"):
        dt.softmask(_t(X), _t(R[:, :3]))


def test_magphase_matches_jax():
    rng = np.random.default_rng(5)
    D = (rng.standard_normal((9, 11)) + 1j * rng.standard_normal((9, 11))).astype(
        np.complex64)
    D[0, 0] = 0
    for power in (1, 2):
        mag, phase = dt.magphase(_t(D), power=power)
        mag_j, phase_j = dj.magphase(D, power=power)
        np.testing.assert_allclose(mag.numpy(), np.asarray(mag_j), rtol=1e-6)
        np.testing.assert_allclose(phase.numpy(), np.asarray(phase_j), atol=1e-6)


def _spectrogram(seed=6, complex_=False):
    rng = np.random.default_rng(seed)
    S = np.abs(rng.standard_normal((65, 120))).astype(np.float32)
    S[20, :] += 10.0
    S[:, 60] += 10.0
    if complex_:
        S = (S * np.exp(1j * rng.uniform(0, 2 * np.pi, S.shape))).astype(np.complex64)
    return S


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("kw", [dict(kernel_size=11), dict(kernel_size=(7, 13), margin=2.0),
                                dict(kernel_size=31, mask=True),
                                dict(kernel_size=9, power=np.inf)])
def test_hpss_matches_jax(complex_, kw):
    S = _spectrogram(complex_=complex_)
    H, P = dt.hpss(_t(S), **kw)
    Hj, Pj = dj.hpss(S, **kw)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), atol=1e-5)
    np.testing.assert_allclose(P.numpy(), np.asarray(Pj), atol=1e-5)
    h = dt.harmonic(_t(S), **kw)
    np.testing.assert_array_equal(h.numpy(), H.numpy())


def test_hpss_partition_and_batch():
    """tests/test_decompose.py:28-40 on the port, and a (C, F, T) batch equal
    to its channels one at a time."""
    S = np.stack([_spectrogram(7), _spectrogram(8) * 0.5])
    H, P = dt.hpss(_t(S), kernel_size=11)
    np.testing.assert_allclose((H + P).numpy(), S, atol=1e-3)
    assert H[0, 20, 30] > P[0, 20, 30] and P[0, 40, 60] > H[0, 40, 60]
    for c in range(2):
        Hc, Pc = dt.hpss(_t(S[c]), kernel_size=11)
        np.testing.assert_array_equal(H[c].numpy(), Hc.numpy())
        np.testing.assert_array_equal(P[c].numpy(), Pc.numpy())
    with pytest.raises(ValueError, match="Margins"):
        dt.hpss(_t(S), margin=0.5)
