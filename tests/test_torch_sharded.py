"""The port's fused and fixed-length mesh tiers (``parallel/sharded.py``) on
the CPU, in worlds of gloo ranks: one spawned world for each mesh
factorization (1x1, 1x2, 1x4, 2x2) runs every case of this file and writes
its results to .npz files; the tests below read them.

* ``restore_fused_sharded`` against the port's dense fused restore, bit for
  bit, at test_sharded_fast.py's shapes with shards of 300 segments (not a
  multiple of the 1024-segment split-cumsum block): tracked, K1's plan entry
  (its plain version here) within 2e-5 of K2's, mixed lengths against the
  solo runs, the shared curve against the (C, n) restore, the speed-curve
  replay within 2e-5 of the dense sinc, and the wrapped plan's unwrap;
* against JAX's ``restore_fused_sharded`` at the same mesh: the speed
  curves within 2e-5, the output by the compacted-sample rule
  (test_restore_fused.py:58-96);
* ``restore_step`` linear and sinc: flutter under 0.5x and 0.6x of the
  input's (test_sharded.py:71-101), and against JAX's ``restore_step`` at
  the same mesh, inside JAX's halo; a wow whose
  positions run past the default drift halo; a padded take centred on its
  own frames;
* ``lag_resample_sharded`` within 5e-5 of the port's dense ``sinc_resample``
  in the interior (test_sharded_fast.py:171-195) and within 1e-4 of JAX's
  ``lag_resample_sharded`` at the same mesh;
* the int32 cap on a rank's flattened signal.

The ranks import only the port and numpy: JAX is imported in the test
process alone, inside the tests that compare with it.  The dense references
of the bit-equality cases run on rank 0 of each world, where the CPU BLAS
runs one thread as the ranks do (mesh.launch)."""

import os
import sys

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu_torch.parallel import batch as tb
from pyaudiorestoration_tpu_torch.parallel import mesh as tm
from pyaudiorestoration_tpu_torch.parallel import sharded as ts

FACTORS = [(1, 1), (1, 2), (1, 4), (2, 2)]
SR = 16384
STEP, NFFT, ZP = 64, 256, 1
F0 = 2048.0
F0_BIN = int(round(F0 * NFFT * ZP / SR))
BAND = (F0_BIN - 5, F0_BIN + 6)
MAX_N, NT, DRIFT = int(STEP * 1.25), 50, 16
TL = 300  # segments a shard
WRAP = 12  # bits: the plan wraps every 4096 samples at this size


def _wobble_take(n, depth=0.01, rates=(1.3, 4.7), seed_phase=0.0):
    t = np.arange(n) / SR
    speed = 1.0 + sum(depth * (0.5 ** i) * np.sin(2 * np.pi * r * t + seed_phase + i)
                      for i, r in enumerate(rates))
    return np.sin(2 * np.pi * F0 * np.cumsum(speed) / SR).astype(np.float32)


def _bands(n):
    F = n // STEP + 1
    return np.full(F, F0_BIN - 4, np.int32), np.full(F, F0_BIN + 5, np.int32)


def _takes(n_time):
    n = TL * STEP * n_time
    return np.stack([_wobble_take(n), 0.8 * _wobble_take(n, 0.012, (0.9,), 0.5)])


def _mixed(n_time):
    """Two takes padded to the batch length with their reflect continuation:
    one with an odd remainder, one ending on a shard boundary (or mid-take
    on one shard)."""
    total = TL * STEP * n_time
    lengths = [total - 3 * STEP - 77, total // 2]
    takes = [_wobble_take(L, 0.011, (1.2 + 0.5 * i,), 0.4 * i)
             for i, L in enumerate(lengths)]
    x = np.zeros((2, total), np.float32)
    for i, (L, s) in enumerate(zip(lengths, takes)):
        x[i, :L] = s
        tb.reflect_continue(x[i], L, NFFT)
    return x, lengths, takes


def _curve(n):
    F = n // STEP + 1
    t = np.arange(F) * STEP / SR
    return (1.0 + 0.008 * np.sin(2 * np.pi * 1.1 * t)).astype(np.float32)


STEP_SR, STEP_F0 = 8192, 1024.0


def _step_take():
    n = 4 * STEP_SR
    t = np.arange(n) / STEP_SR
    speed = 1.0 + 0.02 * np.sin(2 * np.pi * 2.0 * t)
    sig = np.sin(2 * np.pi * STEP_F0 * np.cumsum(speed) / STEP_SR).astype(np.float32)
    return np.stack([sig, sig])


DRIFT_SR = 16384


def _drift_take():
    """3 % wow at 0.25 Hz: the positions run up to 2 x 313 samples from
    their output index (the integral of the wow, 1 - cos), past the
    default 256-sample drift halo."""
    n = 8 * DRIFT_SR
    t = np.arange(n) / DRIFT_SR
    speed = 1.0 + 0.03 * np.sin(2 * np.pi * 0.25 * t)
    sig = np.sin(2 * np.pi * STEP_F0 * np.cumsum(speed) / DRIFT_SR).astype(np.float32)
    return np.stack([sig, sig])


STEP_CUT = 3 * STEP_SR // 2  # the second take of the padded step batch ends here


def _padded_step_batch():
    x = _step_take()
    x[1, STEP_CUT:] = 0.0
    return x, [x.shape[1], STEP_CUT]


LAG_SR, LAG_HOP, LAG_N = 8192, 128, 65536


def _lag_case():
    t = np.arange(LAG_N) / LAG_SR
    sig = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    st = np.linspace(0, LAG_N, 33)
    lg = 40 * np.sin(np.linspace(0, 3 * np.pi, 33))  # both signs: both halos read
    return np.stack([sig, 0.5 * sig]), st, lg


def _fused_kw():
    return dict(zeropad=ZP, max_n=MAX_N, nt=NT, drift=DRIFT, band=BAND)


def _world(dev, nf, nt, out_dir):
    """Every case on a (nf, nt) mesh; rank 0 writes the gathered results
    and the dense references."""
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rd

    mesh = tm.Mesh(nf, nt, dev)
    gather = tm.gather_time_batch
    res = {}
    x = _takes(nt)
    n = x.shape[1]
    NL, NU = _bands(n)
    xs = tm.shard_time_batch(mesh, x)
    kw = _fused_kw()
    for name, extra in (("fused", {}), ("pallas", {"backend": "pallas"}),
                        ("wrap", {"wrap_bits": WRAP})):
        out = ts.restore_fused_sharded(mesh, xs, NL, NU, NFFT, STEP, **kw, **extra)
        for key, t in zip(("padded", "nn", "bi", "bf"), out):
            res[f"{name}/{key}"] = gather(mesh, t)
    plan = ts.fused_sharded_plan(mesh, xs, NL, NU, NFFT, STEP, ZP, MAX_N, NT, DRIFT,
                                 band=BAND)
    res["fused/speeds"] = gather(mesh, plan["speeds"][:, :-1].contiguous())

    xm, lengths, takes = _mixed(nt)
    out = ts.restore_fused_sharded(mesh, tm.shard_time_batch(mesh, xm), NL, NU, NFFT,
                                   STEP, **kw, lengths=lengths)
    res["mixed/padded"] = gather(mesh, out[0])

    sig = x[0]
    xc = np.stack([sig, 0.7 * sig])
    out = ts.restore_fused_sharded(mesh, tm.shard_time_batch(mesh, xc), NL, NU, NFFT,
                                   STEP, **kw, share_curve=True)
    res["share/padded"] = gather(mesh, out[0])

    curve = _curve(n)
    out = ts.restore_fused_sharded(mesh, xs, NL, NU, NFFT, STEP, **kw,
                                   speed_curve=np.stack([curve, curve]))
    for key, t in zip(("padded", "nn", "bi", "bf"), out):
        res[f"replay/{key}"] = gather(mesh, t)

    xstep = _step_take()
    xss = tm.shard_time_batch(mesh, xstep)
    res["step/linear"] = gather(mesh, ts.restore_step(mesh, xss, STEP_F0, STEP_SR,
                                                      n_fft=512, step=128))
    res["step/sinc"] = gather(mesh, ts.restore_step(mesh, xss, STEP_F0, STEP_SR,
                                                    n_fft=512, step=128, interp="sinc",
                                                    nt=16))
    res["step/rel"] = gather(mesh, ts.step_positions(mesh, xss, STEP_F0, STEP_SR, 512,
                                                     128)[0])
    xd = tm.shard_time_batch(mesh, _drift_take())
    res["drift/out"] = gather(mesh, ts.restore_step(mesh, xd, STEP_F0, DRIFT_SR, n_fft=512,
                                                    step=128))
    rel, _ = ts.step_positions(mesh, xd, STEP_F0, DRIFT_SR, 512, 128)
    res["drift/halo"] = np.array(ts.step_halo(mesh, rel, 256))
    xp, plen = _padded_step_batch()
    res["steplen/out"] = gather(mesh, ts.restore_step(
        mesh, tm.shard_time_batch(mesh, xp), STEP_F0, STEP_SR, n_fft=512, step=128,
        lengths=plen))
    xl, st, lg = _lag_case()
    res["lag/out"] = gather(mesh, ts.lag_resample_sharded(
        mesh, tm.shard_time_batch(mesh, xl), st, lg, hop=LAG_HOP, nt=16, drift=8))

    if mesh.rank == 0:
        for i in range(2):
            res[f"dense/fused{i}"] = rd.restore_fused_device(
                x[i], NL, NU, NFFT, STEP, ZP, MAX_N, NT, DRIFT, band=BAND,
                device="cpu").numpy()
        for i, (L, s) in enumerate(zip(lengths, takes)):
            Fi = L // STEP + 1
            res[f"dense/solo{i}"] = rd.restore_fused_device(
                s, NL[:Fi], NU[:Fi], NFFT, STEP, ZP, MAX_N, NT, DRIFT, band=BAND,
                device="cpu").numpy()
        res["dense/share"] = rd.restore_fused_device(
            xc, NL, NU, NFFT, STEP, ZP, MAX_N, NT, DRIFT, band=BAND, device="cpu").numpy()
        d_bound = min(0.9, max(DRIFT - 2, 1) / MAX_N)
        cc = torch.as_tensor(np.clip(curve, np.float32(1 / (1 + d_bound)),
                                     np.float32(1 / (1 - d_bound))))
        res["dense/replay"] = rd.sinc_banded_device(
            torch.as_tensor(sig), cc, torch.as_tensor(res["replay/nn"][0]),
            torch.as_tensor(res["replay/bi"][0].astype(np.int32)),
            torch.as_tensor(res["replay/bf"][0]), MAX_N, NT, DRIFT).numpy()
        np.savez(os.path.join(out_dir, f"{nf}x{nt}.npz"), **res)
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "pyaudiorestoration_tpu"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_worlds")
    loaded = {}
    for nf, nt in FACTORS:
        loaded[(nf, nt)] = tm.launch(_world, nf * nt, (nf, nt, str(d)), device="cpu",
                                     spawn=True, timeout_s=600)
    return {f: dict(np.load(d / f"{f[0]}x{f[1]}.npz")) for f in FACTORS}, loaded


def _ids(f):
    return f"{f[0]}x{f[1]}"


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_ranks_import_no_jax(worlds, f):
    assert worlds[1][f] == [[]] * (f[0] * f[1])


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_fused_sharded_bit_equal_to_dense(worlds, f):
    r = worlds[0][f]
    T = TL * f[1]
    assert r["fused/padded"].shape == (2, T, MAX_N)
    assert r["fused/bi"].dtype == np.int64
    for i in range(2):
        assert np.array_equal(r["fused/padded"][i], r[f"dense/fused{i}"])


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_fused_sharded_k1_plan_entry_matches_k2(worlds, f):
    r = worlds[0][f]
    assert np.array_equal(r["pallas/nn"], r["fused/nn"])
    np.testing.assert_allclose(r["pallas/padded"], r["fused/padded"], atol=2e-5)


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_fused_sharded_mixed_lengths_bit_equal_to_solo(worlds, f):
    r = worlds[0][f]
    for i in range(2):
        solo = r[f"dense/solo{i}"]
        assert np.array_equal(r["mixed/padded"][i, :solo.shape[0]], solo)


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_fused_sharded_shared_curve_bit_equal_to_channels(worlds, f):
    r = worlds[0][f]
    assert np.array_equal(r["share/padded"], r["dense/share"])


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_fused_sharded_speed_curve_replay(worlds, f):
    r = worlds[0][f]
    np.testing.assert_allclose(r["replay/padded"][0], r["dense/replay"], atol=2e-5)
    for key in ("nn", "bi", "bf"):  # one curve, one plan for both rows
        assert np.array_equal(r[f"replay/{key}"][0], r[f"replay/{key}"][1])


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_wrapped_plan_unwraps_and_validates(worlds, f):
    """``wrap_bits`` wraps the returned positions only: the host unwrap
    gives the int64 plan back, and ``validate_plan`` accepts it."""
    r = worlds[0][f]
    bi, bi_w, bf = r["fused/bi"], r["wrap/bi"], r["fused/bf"]
    assert bi.max() >= 1 << WRAP  # the plan really wraps at this size
    assert np.array_equal(bi_w, ts.wrap_base_int(bi, WRAP))
    assert np.array_equal(r["wrap/padded"], r["fused/padded"])
    assert np.array_equal(ts.unwrap_base_int(bi_w, bits=WRAP), bi)
    T = bi.shape[1]
    for j in range(2):
        pos = tb.validate_plan(bi_w[j], bf[j], STEP, T, NT + DRIFT + 18, wrap_bits=WRAP)
        np.testing.assert_array_equal(pos, bi[j] + bf[j].astype(np.float64))


def test_unwrap_and_validate_at_20_bits():
    """The unwrap at 20 bits, on a synthetic one-hop plan that wraps ~60
    times, through ``validate_plan``."""
    T = 1_000_000
    bi = np.arange(T, dtype=np.int64) * STEP + (np.arange(T) % 3)
    bf = np.random.default_rng(3).random(T).astype(np.float32)
    w = ts.wrap_base_int(bi, 20)
    assert w.min() < 0 and w.max() < 1 << 19
    assert np.array_equal(ts.unwrap_base_int(w, bits=20), bi)
    pos = tb.validate_plan(w, bf, STEP, T, slack=4, wrap_bits=20)
    np.testing.assert_array_equal(pos, bi + bf.astype(np.float64))


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's restore_fused_sharded at each factorization, and its dense
    speed curves (the JAX tier holds sharded == dense bit for bit)."""
    import jax
    import jax.numpy as jnp

    from pyaudiorestoration_tpu.parallel import mesh as jm
    from pyaudiorestoration_tpu.parallel import sharded as js
    from pyaudiorestoration_tpu.pipelines import respeeder_device as jrd

    out = {}
    for nf, nt in FACTORS:
        x = _takes(nt)
        NL, NU = _bands(x.shape[1])
        mesh = jm.make_mesh(nf, nt, devices=jax.devices()[:nf * nt])
        pad, nn, _, _ = (np.asarray(a) for a in js.restore_fused_sharded(
            mesh, jm.shard_time_batch(mesh, x), NL, NU, NFFT, STEP, ZP, MAX_N, NT,
            DRIFT, band=BAND))
        d_bound = min(0.9, max(DRIFT - 2, 1) / MAX_N)
        speeds = [np.clip(np.asarray(jrd.track_speed_device(
            jnp.asarray(x[i]), jnp.asarray(NL), jnp.asarray(NU), NFFT, STEP, ZP,
            band=BAND)), np.float32(1 / (1 + d_bound)), np.float32(1 / (1 - d_bound)))
            for i in range(2)]
        out[(nf, nt)] = pad, nn, speeds
    return out


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_fused_sharded_speed_curves_match_jax(worlds, jax_refs, f):
    got = worlds[0][f]["fused/speeds"]
    for i in range(2):
        want = jax_refs[f][2][i][:-1]
        np.testing.assert_allclose(got[i], want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_fused_sharded_output_matches_jax(worlds, jax_refs, f):
    """The compacted outputs by test_restore_fused.py:88-96's rule: median
    |d| < 1e-4 and under 1 % of samples over 1e-2."""
    r = worlds[0][f]
    pad_j, nn_j, _ = jax_refs[f]
    for i in range(2):
        a = ts.compact_padded_host(r["fused/padded"][i], r["fused/nn"][i])
        b = ts.compact_padded_host(pad_j[i], nn_j[i])
        assert abs(len(a) - len(b)) <= 2
        m = min(len(a), len(b)) - 100
        err = np.abs(a[100:m] - b[100:m])
        assert np.median(err) < 1e-4 and (err > 1e-2).mean() < 0.01


@pytest.fixture(scope="module")
def jax_step_refs():
    """JAX's ``restore_step`` (linear, and sinc at nt 16) and
    ``lag_resample_sharded`` at each factorization, on the worlds' inputs."""
    import jax

    from pyaudiorestoration_tpu.parallel import mesh as jm
    from pyaudiorestoration_tpu.parallel import sharded as js

    x = _step_take()
    xl, st, lg = _lag_case()
    out = {}
    for nf, nt in FACTORS:
        mesh = jm.make_mesh(nf, nt, devices=jax.devices()[:nf * nt])
        xs = jm.shard_time_batch(mesh, x)
        out[(nf, nt)] = {
            "linear": np.asarray(js.restore_step(mesh, xs, STEP_F0, STEP_SR, n_fft=512,
                                                 step=128)),
            "sinc": np.asarray(js.restore_step(mesh, xs, STEP_F0, STEP_SR, n_fft=512,
                                               step=128, interp="sinc", nt=16)),
            "lag": np.asarray(js.lag_resample_sharded(
                mesh, jm.shard_time_batch(mesh, xl), st, lg, hop=LAG_HOP, nt=16,
                drift=8))}
    return out


@pytest.mark.parametrize("interp", ["linear", "sinc"])
@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_restore_step_matches_jax(worlds, jax_step_refs, f, interp):
    """The port's ``restore_step`` against JAX's at the same mesh, every
    sample.  Every position stays inside JAX's shard and 256-sample right
    halo here (the wow moves them ~13 samples), so JAX clamps none, and
    the port's two-sided, growing halo reads what JAX reads.

    Tolerance at output j: |d| <= 2e-3 + w * 2e-6 * j, w = 2 pi 1000 / 8192
    the tone's phase step.  Both tiers centre the speed curve on a float32
    mean of log2 speeds near 6 (ulp 4.8e-7), summed over the shards in
    their own order: a rounding of the mean scales every position, up to
    2e-6 of j (six ulps, times ln 2), and the 2e-3 covers the float32
    position sums at the start.  Measured: at most 4.6e-4 over the first
    1,024 outputs and 8.3e-7 * w * j past them (1x4).  A gather one sample
    off, or a halo read from the wrong shard, is off by ~0.77 and ~1."""
    r = worlds[0][f]
    got, want, rel = r[f"step/{interp}"], jax_step_refs[f][interp], r["step/rel"]
    local = want.shape[1] // f[1]
    assert got.shape == want.shape
    assert np.all((rel >= 0) & (rel <= local + 256 - 2))
    w = 2 * np.pi * STEP_F0 / STEP_SR
    bound = 2e-3 + w * 2e-6 * np.arange(want.shape[1])
    assert np.all(np.abs(got - want) <= bound[None, :])


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_lag_resample_sharded_matches_jax(worlds, jax_step_refs, f):
    """The port's tapesync export on the mesh against JAX's on the same
    mesh, every sample: the lag (+-40 samples, so the shards read both
    halos) stays inside both tiers' halo, and JAX's float32 lag (the
    port's is float64) is a few 1e-6 samples off (measured 1.18e-5 at
    every factorization)."""
    got, want = worlds[0][f]["lag/out"], jax_step_refs[f]["lag"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_fused_sharded_refuses_a_flat_signal_past_the_int32_cap(monkeypatch):
    """A rank's rows flatten into one signal with int32 anchors: past the
    cap (lowered here to two rows) the restore raises instead of wrapping;
    one row under it runs."""
    x = _takes(1)
    NL, NU = _bands(x.shape[1])
    row = ts.flat_row_samples(x.shape[1], STEP, MAX_N, NT, DRIFT)
    monkeypatch.setattr(ts, "FLAT_CAP", 2 * row)
    mesh = tm.Mesh(1, 1, "cpu")
    with pytest.raises(ValueError, match="int32 anchors"):
        ts.restore_fused_sharded(mesh, torch.as_tensor(x), NL, NU, NFFT, STEP,
                                 **_fused_kw())
    out = ts.restore_fused_sharded(mesh, torch.as_tensor(x[:1]), NL, NU, NFFT, STEP,
                                   **_fused_kw())
    assert out[0].shape == (1, TL, MAX_N)


def _stability(x, sr):
    idx = np.where(np.bitwise_xor(x[1:] > 0, x[:-1] > 0))[0]
    frac = x[idx] / (x[idx] - x[idx + 1])
    cr = idx + frac
    k = 32
    avg = (cr[2 * k:] - cr[:-2 * k]) / k
    fr = 2 * sr / avg
    core = fr[len(fr) // 8:-len(fr) // 8]
    return np.std(core) / np.mean(core)


@pytest.mark.parametrize("interp,factor", [("linear", 0.5), ("sinc", 0.6)])
@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_restore_step_restores(worlds, f, interp, factor):
    out = worlds[0][f][f"step/{interp}"]
    x = _step_take()
    assert out.shape == x.shape and np.all(np.isfinite(out))
    assert np.array_equal(out[0], out[1])
    before = _stability(x[0].astype(float), STEP_SR)
    assert _stability(out[0].astype(float), STEP_SR) < before * factor


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_restore_step_follows_a_drift_past_its_halo(worlds, f):
    """The drift halo grows to the positions' largest distance from their
    output index (~626 samples here), so no shard clamps them."""
    r = worlds[0][f]
    assert 600 < int(r["drift/halo"]) < 700
    x, out = _drift_take(), r["drift/out"]
    assert np.all(np.isfinite(out)) and np.array_equal(out[0], out[1])
    before = _stability(x[0].astype(float), DRIFT_SR)
    assert _stability(out[0].astype(float), DRIFT_SR) < 0.5 * before


def _tone_hz(x, sr):
    idx = np.where(np.bitwise_xor(x[1:] > 0, x[:-1] > 0))[0]
    cr = idx + x[idx] / (x[idx] - x[idx + 1])
    return (len(cr) - 1) / 2 / ((cr[-1] - cr[0]) / sr)


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_restore_step_centres_each_take_on_its_own_frames(worlds, f):
    """With ``lengths``, the zero pad after the second take stays out of its
    speed mean: its restored tone is the first take's within 0.1 %.  (The
    pad's frames, silence in the band, would pull the mean ~4 % low.)"""
    out = worlds[0][f]["steplen/out"]
    span = slice(STEP_SR // 4, STEP_CUT - STEP_SR // 4)
    a, b = (_tone_hz(out[i, span].astype(float), STEP_SR) for i in range(2))
    assert abs(b / a - 1) < 1e-3


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_lag_resample_sharded_matches_dense_sinc(worlds, f):
    from pyaudiorestoration_tpu_torch.ops import resampling

    out = worlds[0][f]["lag/out"]
    x, st, lg = _lag_case()
    pos = np.clip(np.interp(np.arange(LAG_N), st, st - lg), 0, LAG_N)
    ref = resampling.sinc_resample(x[0], pos, quality=16, device="cpu")
    m = min(len(ref), out.shape[1])
    np.testing.assert_allclose(out[0, 200:m - 200], ref[200:m - 200], atol=5e-5)
    np.testing.assert_allclose(out[1], 0.5 * out[0], atol=5e-6)
