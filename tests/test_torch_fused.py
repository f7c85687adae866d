"""The port's device plan, fused single-take restore and batch of takes
against the JAX package on the CPU: the fixed-order scans, the plan given
JAX's own speeds, ``restore_fused_device`` with both sinc backends, and
``restore_fused_takes`` with and without ``lengths``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.pipelines import respeeder_device as rj
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

torch.set_num_threads(2)

# test_restore_fused.py:173-308's takes: a 1024 Hz tone at 8192 Hz
SR, NFFT, STEP, ZP, F0 = 8192, 512, 128, 1, 1024.0
F0_BIN = int(round(F0 * NFFT * ZP / SR))
BAND = (F0_BIN - 6, F0_BIN + 7)
MAX_N = int(STEP * 1.25)


def _take(n, rate, phase=0.0, depth=0.012, sr=SR, f0=F0):
    t = np.arange(n) / sr
    speed = 1.0 + depth * np.sin(2 * np.pi * rate * t + phase)
    return np.sin(2 * np.pi * f0 * np.cumsum(speed) / sr).astype(np.float32)


def _bands(frames, batch=None):
    shape = (frames,) if batch is None else (batch, frames)
    return (np.full(shape, BAND[0] + 2, np.int32), np.full(shape, BAND[1] - 2, np.int32))


def _compacted(padded, n):
    return padded[np.arange(padded.shape[-1])[None, :] < np.asarray(n)[:, None]]


def _assert_compacted_close(a, b):
    """test_restore_fused.py:88-96: dither boundaries may fall a sample
    apart in rare segments, so hold the median and the share of outliers."""
    assert abs(len(a) - len(b)) <= 2
    m = min(len(a), len(b)) - 100
    err = np.abs(a[100:m] - b[100:m])
    assert np.median(err) < 1e-4, np.median(err)
    assert (err > 1e-2).mean() < 0.01


# ---------------------------------------------------------------- scans

@pytest.mark.parametrize("shape", [(4, 1), (3, 7), (5, 160), (2, 563), (1, 1025)])
def test_tree_sum_last_bit_equal(shape):
    x = (np.random.default_rng(shape[1]).standard_normal(shape) * 0.02).astype(np.float32)
    ref = np.asarray(jax.jit(rj._tree_sum_last)(jnp.asarray(x)))
    assert np.array_equal(rt._tree_sum_last(torch.from_numpy(x)).numpy(), ref)


@pytest.mark.parametrize("T,max_n,seg_chunk", [(300, 563, 32768), (5000, 160, 1000)])
def test_segment_advances_bit_equal(T, max_n, seg_chunk):
    """Against JAX's segment_advances as its jitted plan compiles it (the
    chunked case maps a jitted body): there XLA fuses the lerp into an FMA."""
    rng = np.random.default_rng(T)
    s = (1 + 0.02 * rng.standard_normal(T + 1)).astype(np.float32)
    nn = rng.integers(0, max_n + 1, T).astype(np.int32)
    nn[:3] = [0, 1, max_n]
    ref = np.asarray(jax.jit(rj.segment_advances, static_argnums=(3, 4))(
        jnp.asarray(s[:-1]), jnp.asarray(s[1:]), jnp.asarray(nn), max_n, seg_chunk))
    got = rt.segment_advances(torch.from_numpy(s[:-1]), torch.from_numpy(s[1:]),
                              torch.from_numpy(nn), max_n, seg_chunk).numpy()
    assert np.array_equal(got, ref)
    whole = rt.segment_advances(torch.from_numpy(s[:-1]), torch.from_numpy(s[1:]),
                                torch.from_numpy(nn), max_n).numpy()
    assert np.array_equal(got, whole)  # the chunking only bounds memory


@pytest.mark.parametrize("T", [1, 31, 1023, 1024, 1025, 70000])
def test_split_cumsum_exclusive_bit_equal(T):
    x = (512.0 + np.random.default_rng(T).standard_normal(T) * 5).astype(np.float32)
    ri, rf = (np.asarray(a) for a in jax.jit(rj._split_cumsum_exclusive)(jnp.asarray(x)))
    gi, gf = rt._split_cumsum_exclusive(torch.from_numpy(x))
    assert gi.dtype == torch.int32 and gf.dtype == torch.float32
    assert np.array_equal(gi.numpy(), ri) and np.array_equal(gf.numpy(), rf)
    # leading axes are independent rows
    bi, bf = rt._split_cumsum_exclusive(torch.from_numpy(np.stack([x, x[::-1].copy()])))
    assert np.array_equal(bi[0].numpy(), ri) and np.array_equal(bf[0].numpy(), rf)


def test_split_cumsum_exclusive_precision():
    """test_restore_fused.py:9-24: sub-sample accurate at ~1e8 totals."""
    rng = np.random.default_rng(11)
    x = (512.0 + rng.standard_normal(200000) * 5).astype(np.float64)
    ints, fracs = rt._split_cumsum_exclusive(torch.from_numpy(x.astype(np.float32)))
    ref = np.concatenate([[0.0], np.cumsum(x)[:-1]])
    got = ints.numpy().astype(np.float64) + fracs.numpy().astype(np.float64)
    assert np.abs(got - ref).max() < 0.5
    assert np.all(fracs.numpy() >= 0) and np.all(fracs.numpy() < 1)
    ref32 = np.concatenate([[0.0], np.cumsum(x.astype(np.float32).astype(np.float64))[:-1]])
    assert np.abs(got - ref32).max() < 2e-2


@pytest.mark.parametrize("curve", ["const_lo", "const_hi", "square", "sine+noise"])
def test_split_cumsum_exclusive_multihour_clip_bounds(curve):
    """test_restore_fused.py:27-57: ~1 h curves pinned at the clip bounds,
    within 2e-4 of float64 truth and bit-equal to JAX's."""
    hop, d_bound, T = 512, 0.3, 1_350_000
    lo, hi = 1 / (1 + d_bound), 1 / (1 - d_bound)
    idx = np.arange(T + 1)
    sp = {"const_lo": lambda: np.full(T + 1, lo),
          "const_hi": lambda: np.full(T + 1, hi),
          "square": lambda: np.where(idx // 1000 % 2 == 0, lo, hi),
          "sine+noise": lambda: np.clip(
              1 + 0.25 * np.sin(idx * 2e-4)
              + np.random.default_rng(0).standard_normal(T + 1) * 0.02, lo, hi)}[curve]()
    sp32 = sp.astype(np.float32)
    n_raw = (hop * (sp32[:-1].astype(np.float64)
                    + sp32[1:].astype(np.float64)) / 2.0).astype(np.float32)
    ints, fracs = (a.numpy() for a in rt._split_cumsum_exclusive(torch.from_numpy(n_raw)))
    got = ints.astype(np.float64) + fracs.astype(np.float64)
    ref = np.concatenate([[0.0], np.cumsum(n_raw.astype(np.float64))[:-1]])
    assert np.abs(got - ref).max() < 2e-4
    assert np.all(fracs >= 0) and np.all(fracs < 1)
    ri, rf = rj._split_cumsum_exclusive(jnp.asarray(n_raw))
    assert np.array_equal(ints, np.asarray(ri)) and np.array_equal(fracs, np.asarray(rf))


# ---------------------------------------------------------------- plan

@pytest.mark.parametrize("sr,n_fft,step,zp,f0,n,drift", [
    (8192, 512, 128, 1, 1024.0, 4 * 8192, 16),
    (16384, 256, 64, 1, 2048.0, 3 * 16384 + 77, 16),
    (22050, 2048, 512, 2, 2000.0, 49999, 64)])
def test_plan_from_jax_speeds(sr, n_fft, step, zp, f0, n, drift):
    """Fed the speeds JAX's jitted _fused_plan returns, the port's plan has
    the same counts and anchors, and base_frac bit for bit (the contract
    allows 2e-4, respeeder_device.py:650-669)."""
    x = _take(n, 1.3, depth=0.02, sr=sr, f0=f0)
    fb = int(round(f0 * n_fft * zp / sr))
    band = (fb - 6, fb + 7)
    F = n // step + 1
    max_n = int(step * 1.1)
    speeds, nn, bi, bf = (np.asarray(a) for a in rj._fused_plan(
        jnp.asarray(x), jnp.full((F,), fb - 4, jnp.int32),
        jnp.full((F,), fb + 5, jnp.int32), n_fft, step, zp, max_n, 16, drift,
        "blackmanharris", band))
    got = [a.numpy() for a in rt._plan_from_speeds(torch.from_numpy(speeds.copy()),
                                                   step, max_n, drift)]
    assert np.array_equal(got[0], speeds)  # the clip is idempotent
    assert np.array_equal(got[1], nn) and np.array_equal(got[2], bi)
    assert np.abs(got[3].astype(np.float64) - bf).max() <= 2e-4
    assert np.array_equal(got[3], bf)


def test_sinc_backend_values():
    assert rt._sinc_backend("auto", "cpu") == "xla"
    assert rt._sinc_backend("auto", torch.device("cuda")) == "pallas"
    assert rt._sinc_backend("pallas", "cpu") == "pallas"
    with pytest.raises(ValueError, match="unknown sinc backend"):
        rt._sinc_backend("mosaic", "cpu")


# ---------------------------------------------------------------- single take

@pytest.fixture(scope="module")
def single_take():
    """test_sharded_fast.py's shapes: a 2048 Hz tone at 16384 Hz, 3 s,
    wow and flutter."""
    sr, n_fft, step = 16384, 256, 64
    n = 3 * sr
    t = np.arange(n) / sr
    speed = 1.0 + 0.01 * np.sin(2 * np.pi * 1.3 * t) + 0.005 * np.sin(2 * np.pi * 4.7 * t + 1)
    x = np.sin(2 * np.pi * 2048.0 * np.cumsum(speed) / sr).astype(np.float32)
    fb = int(round(2048.0 * n_fft / sr))
    F = n // step + 1
    NL, NU = np.full(F, fb - 4, np.int32), np.full(F, fb + 5, np.int32)
    args = (NL, NU, n_fft, step, 1, int(step * 1.25), 16, 16)
    kw = dict(band=(fb - 5, fb + 6))
    stereo = np.stack([x, 0.7 * np.roll(x, 1234)])
    out = {}
    for ch, sig in (("mono", x), ("stereo", stereo)):
        out[ch, "jax"] = np.asarray(rj.restore_fused_device(jnp.asarray(sig), *args, **kw))
        for backend in ("xla", "pallas"):
            out[ch, backend] = rt.restore_fused_device(
                sig, *args, backend=backend, device="cpu", **kw).numpy()
    plan_j = rj._fused_plan(jnp.asarray(x), jnp.asarray(NL), jnp.asarray(NU), *args[2:],
                            "blackmanharris", kw["band"])
    plan_t = rt._fused_plan(torch.from_numpy(x), torch.from_numpy(NL), torch.from_numpy(NU),
                            *args[2:], "blackmanharris", kw["band"])
    return out, np.asarray(plan_j[1]), plan_t[1].numpy()


@pytest.mark.parametrize("channels", ["mono", "stereo"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_restore_fused_device_matches_jax(single_take, channels, backend):
    out, n_j, n_t = single_take
    got, ref = out[channels, backend], out[channels, "jax"]
    assert got.shape == ref.shape and got.dtype == np.float32
    for c in range(1 if channels == "mono" else 2):
        g = got if channels == "mono" else got[c]
        r = ref if channels == "mono" else ref[c]
        _assert_compacted_close(_compacted(g, n_t), _compacted(r, n_j))


@pytest.mark.parametrize("channels", ["mono", "stereo"])
def test_restore_fused_device_backends_agree(single_take, channels):
    out, _, _ = single_take
    np.testing.assert_allclose(out[channels, "pallas"], out[channels, "xla"],
                               atol=3e-5, rtol=0)


def test_restore_fused_device_raises_for_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    NL, NU = _bands(9)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rt.restore_fused_device(np.zeros(1024, np.float32), NL, NU, NFFT, STEP, ZP, MAX_N)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        rt.restore_fused_takes(np.zeros((2, 1024), np.float32), *_bands(9, 2), NFFT,
                               STEP, ZP, MAX_N)


# ---------------------------------------------------------------- batch

def test_restore_fused_takes_independent_curves():
    """test_restore_fused.py:173-203: each row equals its solo run, and
    takes with different wow give different outputs."""
    n = 4 * SR
    xb = np.stack([_take(n, 1.0, depth=0.01), _take(n, 3.0, depth=0.01)])
    NL, NU = _bands(n // STEP + 1, 2)
    max_n = int(STEP * 1.1)
    batch = rt.restore_fused_takes(xb, NL, NU, NFFT, STEP, ZP, max_n, 8, 8,
                                   device="cpu").numpy()
    for i in range(2):
        single = rt.restore_fused_device(xb[i], NL[i], NU[i], NFFT, STEP, ZP, max_n,
                                         8, 8, device="cpu").numpy()
        np.testing.assert_allclose(batch[i], single, atol=1e-6, rtol=0)
    assert not np.allclose(batch[0], batch[1], atol=1e-3)


@pytest.fixture(scope="module")
def mixed_batch():
    """test_restore_fused.py:255-308: one length not a multiple of step."""
    lengths = [3 * SR + 77, 2 * SR, 4 * SR]
    takes = [_take(L, 1.0 + 0.7 * i, 0.3 * i) for i, L in enumerate(lengths)]
    xb = np.zeros((3, max(lengths)), np.float32)
    for i, s in enumerate(takes):
        xb[i, :len(s)] = s
    NL, NU = _bands(xb.shape[1] // STEP + 1, 3)
    return lengths, takes, xb, NL, NU


def _solo(sig, NL, NU, backend="xla"):
    F = len(sig) // STEP + 1
    return rt.restore_fused_device(sig, NL[:F], NU[:F], NFFT, STEP, ZP, MAX_N, 16, 16,
                                   backend=backend, band=BAND, device="cpu").numpy()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_mixed_length_batch_bit_equal_to_solo(mixed_batch, backend):
    lengths, takes, xb, NL, NU = mixed_batch
    batch = rt.restore_fused_takes(xb, NL, NU, NFFT, STEP, ZP, MAX_N, 16, 16,
                                   backend=backend, band=BAND, lengths=lengths,
                                   device="cpu").numpy()
    for i, (L, sig) in enumerate(zip(lengths, takes)):
        solo = _solo(sig, NL[i], NU[i], backend)
        assert solo.shape[0] == L // STEP
        assert np.array_equal(batch[i, :solo.shape[0]], solo), i


def test_batch_without_lengths_is_perturbed_by_the_pad(mixed_batch):
    lengths, takes, xb, NL, NU = mixed_batch
    plain = rt.restore_fused_takes(xb, NL, NU, NFFT, STEP, ZP, MAX_N, 16, 16,
                                   band=BAND, device="cpu").numpy()
    solo0 = _solo(takes[0], NL[0], NU[0])
    assert not np.array_equal(plain[0, :solo0.shape[0]], solo0)


def test_mixed_length_batch_matches_jax(mixed_batch):
    lengths, takes, xb, NL, NU = mixed_batch
    ref = np.asarray(rj.restore_fused_takes(
        jnp.asarray(xb), jnp.asarray(NL), jnp.asarray(NU), NFFT, STEP, ZP, MAX_N, 16,
        16, band=BAND, lengths=np.asarray(lengths)))
    got, nn, _, _ = rt._restore_fused_takes(
        xb, NL, NU, NFFT, STEP, ZP, MAX_N, 16, 16, "blackmanharris", "xla", BAND,
        lengths, "cpu")
    assert got.shape == ref.shape
    for i, L in enumerate(lengths):
        F = L // STEP + 1
        n_j = np.asarray(rj._fused_plan(
            jnp.asarray(takes[i]), jnp.asarray(NL[i, :F]), jnp.asarray(NU[i, :F]), NFFT,
            STEP, ZP, MAX_N, 16, 16, "blackmanharris", BAND)[1])
        T = L // STEP
        _assert_compacted_close(_compacted(got[i, :T].numpy(), nn[i, :T].numpy()),
                                _compacted(ref[i, :T], n_j))
