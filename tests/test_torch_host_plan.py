"""The port's host-side numpy copies are bit-equal to the JAX package's, and
``plan_to_torch`` carries a plan over unchanged."""

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.ops import fourier as fj
from pyaudiorestoration_tpu.pipelines import respeeder_device as rj
from pyaudiorestoration_tpu_torch.ops import fourier as ft
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils.convert import plan_to_torch

torch.set_num_threads(2)


def _speeds(T, depth, seed, hz=1.3):
    rng = np.random.default_rng(seed)
    t = np.arange(T + 1) / 40.0
    return (1.0 + depth * np.sin(2 * np.pi * hz * t)
            + 0.002 * rng.standard_normal(T + 1)).astype(np.float32)


# (hop, T, depth, seed, t0, trim): trim < 1 cuts num_input_samples short so
# the end-trim branch runs; hop 1 gives zero- and one-sample segments
PLAN_CASES = [
    (256, 120, 0.03, 0, 0.0, 1.0),
    (512, 80, 0.0, 1, 0.0, 1.0),      # constant speed: the |c| < 1e-12 branch
    (128, 200, 0.2, 2, 17.25, 0.8),
    (1, 64, 0.6, 3, 0.0, 1.0),
    (64, 50, 0.05, 4, 3.5, 0.5),
]


def _assert_plans_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_positions_fast_bit_equal(case):
    hop, T, depth, seed, t0, trim = case
    sp = _speeds(T, depth, seed)
    n_in = int(T * hop * trim)
    _assert_plans_equal(rt.plan_positions_fast(sp, hop, n_in, t0),
                        rj.plan_positions_fast(sp, hop, n_in, t0))


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_positions_bit_equal(case):
    hop, T, depth, seed, t0, trim = case
    sp = _speeds(T, depth, seed)
    n_in = int(T * hop * trim)
    _assert_plans_equal(rt.plan_positions(sp, hop, n_in, t0),
                        rj.plan_positions(sp, hop, n_in, t0))


@pytest.mark.parametrize("case", PLAN_CASES[:3])
def test_compact_output_bit_equal(case):
    hop, T, depth, seed, t0, trim = case
    plan = rj.plan_positions_fast(_speeds(T, depth, seed), hop, int(T * hop * trim))
    rng = np.random.default_rng(seed)
    padded = rng.standard_normal((T, plan["max_n"])).astype(np.float32)
    got = rt.compact_output(padded, plan)
    assert got.dtype == np.float32
    assert np.array_equal(got, rj.compact_output(padded, plan))


@pytest.mark.parametrize("name,n", [("blackmanharris", 4096), ("blackmanharris", 2048),
                                    ("hann", 1024), ("hann", 511)])
def test_get_window_bit_equal(name, n):
    a, b = ft.get_window(name, n), fj.get_window(name, n)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b)


@pytest.mark.parametrize("f0,tol,fft,zp,sr", [
    (3000.0, 1.0, 4096, 2, 44100), (1000.0, 0.5, 2048, 4, 16000),
    (0.5, 1.0, 1024, 1, 8000),          # clamps to bin 1
    (95000.0, 2.0, 4096, 2, 192000),    # clamps to the Nyquist bin
])
def test_band_limits_equal(f0, tol, fft, zp, sr):
    assert rt._band_limits(f0, tol, fft, zp, sr) == rj._band_limits(f0, tol, fft, zp, sr)


@pytest.mark.parametrize("n,sr,f0", [(30000, 22050, 3000.0), (300000, 192000, 7000.0),
                                     (5000, 8000, 440.0)])
def test_probe_f0_equal(n, sr, f0):
    rng = np.random.default_rng(n)
    t = np.arange(n) / sr
    x = (np.sin(2 * np.pi * f0 * t) * 0.5 + 0.01 * rng.standard_normal(n)).astype(np.float32)
    assert rt._probe_f0(x, sr) == rj._probe_f0(x, sr)


@pytest.mark.parametrize("n_fft,zp,lo,hi", [(2048, 2, 550, 600), (4096, 2, 130, 150),
                                            (1024, 4, 0, 12)])
def test_banded_dft_matrix_bit_equal(n_fft, zp, lo, hi):
    a = rt._banded_dft_matrix(n_fft, zp, lo, hi)
    b = rj._banded_dft_matrix(n_fft, zp, lo, hi)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_inv_count_limbs_and_band_center_equal():
    counts = np.array([1, 7, 216, 11251, 1 << 20])
    assert np.array_equal(rt.inv_count_limbs(counts), rj.inv_count_limbs(counts))
    for band in [None, (550, 600), (0, 1), (130, 151)]:
        assert rt.log_center_for_band(band) == rj.log_center_for_band(band)


def test_plan_to_torch_carries_the_plan():
    plan = rj.plan_positions_fast(_speeds(60, 0.03, 5), 256, 60 * 256)
    p = plan_to_torch(plan, "cpu")
    assert p["n"].dtype == torch.int32 and p["base_int"].dtype == torch.int32
    assert p["base_frac"].dtype == torch.float32
    for k in ("n", "base_int", "base_frac"):
        assert np.array_equal(p[k].numpy(), plan[k]), k
    assert (p["max_n"], p["drift"]) == (plan["max_n"], plan["drift"])


@pytest.mark.parametrize("drift,bucket", [(1, 8), (8, 8), (9, 16), (33, 64), (64, 64)])
def test_drift_bucket(drift, bucket):
    assert rt._drift_bucket(drift) == bucket
