"""The port's tool shards (``parallel/sharded.py``: STFT, iSTFT, HPSS,
renoise, heal, centre of gravity and adaptive peak tracking) on the CPU,
in worlds of gloo ranks: one spawned world for each mesh factorization
(1x1, 1x2, 1x4, 2x2) runs every case and writes its results to .npz files.

Against JAX's mesh functions at the same factorization (computed in the
test process on its virtual CPU devices): the STFT within 2e-4, the HPSS
masks within 1e-5, renoise and heal within 5e-4.  The iSTFT round trip
within 1e-3 of the input in the interior (test_sharded.py:43-53).  The
centre-of-gravity and adaptive chains equal to the port's dense scans with
atol 0 (test_sharded_sequential.py:56).  The ranks import only the port and
numpy."""

import os
import sys

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu_torch.parallel import mesh as tm
from pyaudiorestoration_tpu_torch.parallel import sharded as ts

FACTORS = [(1, 1), (1, 2), (1, 4), (2, 2)]
N_FFT, STEP = 512, 128
SR = 8192


def _noise():
    return np.random.default_rng(11).standard_normal((2, 8192)).astype(np.float32)


def _hpss_input():
    S = np.abs(np.random.default_rng(12).standard_normal((2, 65, 256))).astype(np.float32)
    S[:, 20, :] += 5.0
    S[:, :, 100] += 5.0
    return S


def _renoise_input():
    t = np.arange(4 * SR) / SR
    x = (0.3 * np.sin(2 * np.pi * 440 * t)
         + 0.01 * np.random.default_rng(13).standard_normal(4 * SR)).astype(np.float32)
    profile = np.linspace(-48.0, -40.0, N_FFT // 2 + 1).astype(np.float32)
    return np.stack([x, x * 0.7]), profile, -25.0


def _heal_input():
    t = np.arange(4 * SR) / SR
    x = (0.5 * np.sin(2 * np.pi * 640 * t)).astype(np.float32)
    d0, d1 = int(1.5 * SR), int(1.5 * SR) + 4096
    x[d0:d1] *= 0.1
    gain = np.zeros((2, N_FFT // 2 + 1, len(x) // STEP), np.float32)
    bin_c = round(640 * N_FFT / SR)
    gain[:, bin_c - 3:bin_c + 4, d0 // STEP - 1:d1 // STEP + 1] = 20.0
    return np.stack([x, x]), gain, (d0, d1)


COG_FFT, COG_STEP, COG_SR = 256, 64, 4096


def _cog_input():
    n_frames, num_bins = 256, COG_FFT // 2 + 1
    t = np.arange(n_frames) * COG_STEP / COG_SR
    out = []
    for b in range(2):
        freq = 512.0 * 2 ** (0.05 * np.sin(2 * np.pi * (1.1 + 0.2 * b) * t))
        bins = freq * COG_FFT / COG_SR
        grid = np.arange(num_bins)[:, None]
        out.append(np.exp(-0.5 * ((grid - bins[None, :]) / 1.5) ** 2))
    return (np.stack(out).astype(np.float32) + 1e-6, np.full(2, 28, np.int32),
            np.full(2, 36, np.int32), 2.0 / 12.0)


def _adaptive_input():
    from pyaudiorestoration_tpu_torch.ops import fourier

    n = 32768
    t = np.arange(n) / SR
    f = 1000 * (1 + 0.01 * np.sin(2 * np.pi * 0.7 * t))
    sig = np.sin(2 * np.pi * np.cumsum(f) / SR).astype(np.float32)
    mag = torch.abs(fourier.stft(torch.as_tensor(sig), n_fft=N_FFT, step=STEP)).numpy()
    mag = mag[:, :(mag.shape[1] // 8) * 8]
    mag = np.stack([mag, 0.5 * mag + 1e-3])
    hist0 = np.stack([np.full(4, np.log2(1000.0)), np.full(4, np.log2(1010.0))])
    return mag, hist0.astype(np.float32)


def _block(mesh, a):
    """The rank's (files, ..., time) block of a host array."""
    nf, nt = mesh.shape["files"], mesh.shape["time"]
    bf, bt = a.shape[0] // nf, a.shape[-1] // nt
    f, t = mesh.axis_index("files"), mesh.axis_index("time")
    return torch.as_tensor(np.ascontiguousarray(
        a[f * bf:(f + 1) * bf, ..., t * bt:(t + 1) * bt]), device=mesh.device)


def _world(dev, nf, nt, out_dir):
    from pyaudiorestoration_tpu_torch.models import trackers

    mesh = tm.Mesh(nf, nt, dev)
    g = tm.gather_time_batch
    res = {}
    xs = tm.shard_time_batch(mesh, _noise())
    spec = ts.stft_sharded(mesh, xs, N_FFT, STEP)
    res["stft"] = g(mesh, torch.view_as_real(spec).contiguous(), time_axis=2)
    half = tm.shard_time_batch(mesh, 0.5 * _noise())
    back = ts.istft_sharded(mesh, ts.stft_sharded(mesh, half, N_FFT, STEP, "hann"),
                            N_FFT, STEP, "hann")
    res["istft"] = g(mesh, back)
    mh, mp = ts.hpss_sharded(mesh, _block(mesh, _hpss_input()), kernel_size=9)
    res["hpss_h"], res["hpss_p"] = g(mesh, mh, time_axis=2), g(mesh, mp, time_axis=2)
    x2, profile, gain = _renoise_input()
    res["renoise"] = g(mesh, ts.renoise_sharded(mesh, tm.shard_time_batch(mesh, x2),
                                                profile, gain, N_FFT, STEP, "hann"))
    xh, gdb, _ = _heal_input()
    res["heal"] = g(mesh, ts.heal_sharded(mesh, tm.shard_time_batch(mesh, xh),
                                          _block(mesh, gdb).cpu().numpy(), N_FFT, STEP))
    mag, NL0, NU0, tol = _cog_input()
    rows = slice(mesh.axis_index("files") * (2 // nf), (mesh.axis_index("files") + 1)
                 * (2 // nf))
    res["cog"] = g(mesh, ts.cog_sharded(mesh, _block(mesh, mag), NL0[rows], NU0[rows],
                                        tol, COG_FFT, COG_SR))
    amag, hist0 = _adaptive_input()
    res["adaptive"] = g(mesh, ts.adaptive_peak_sharded(
        mesh, _block(mesh, amag), hist0[rows], 2.0, "Linear", N_FFT, SR))
    if mesh.rank == 0:
        from pyaudiorestoration_tpu_torch.ops.fourier import fft_freqs

        with np.errstate(divide="ignore"):
            lff = torch.as_tensor(np.log2(np.maximum(fft_freqs(COG_FFT, COG_SR), 1e-12))
                                  .astype(np.float32))
        for b in range(2):
            res[f"dense/cog{b}"] = trackers._cog_scan(
                torch.as_tensor(mag[b].T.copy()), lff, torch.tensor(NL0[b]),
                torch.tensor(NU0[b]), tol, COG_FFT, COG_SR).numpy()
            res[f"dense/adaptive{b}"] = trackers._adaptive_peak_scan(
                torch.as_tensor(amag[b].T.copy()),
                tuple(torch.tensor(v) for v in hist0[b]), 2.0, "Linear", N_FFT,
                SR).numpy()
        np.savez(os.path.join(out_dir, f"{nf}x{nt}.npz"), **res)
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "pyaudiorestoration_tpu"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("tool_worlds")
    loaded = {}
    for nf, nt in FACTORS:
        loaded[(nf, nt)] = tm.launch(_world, nf * nt, (nf, nt, str(d)), device="cpu",
                                     spawn=True, timeout_s=600)
    return {f: dict(np.load(d / f"{f[0]}x{f[1]}.npz")) for f in FACTORS}, loaded


@pytest.fixture(scope="module")
def jax_refs():
    import jax

    from pyaudiorestoration_tpu.parallel import mesh as jm
    from pyaudiorestoration_tpu.parallel import sharded as js

    out = {}
    for nf, nt in FACTORS:
        mesh = jm.make_mesh(nf, nt, devices=jax.devices()[:nf * nt])
        spec_sh = jm.NamedSharding(mesh, jm.P("files", None, "time"))
        r = {"stft": np.asarray(js.stft_sharded(mesh, jm.shard_time_batch(mesh, _noise()),
                                                N_FFT, STEP))}
        mh, mp = js.hpss_sharded(mesh, jax.device_put(_hpss_input(), spec_sh),
                                 kernel_size=9)
        r["hpss_h"], r["hpss_p"] = np.asarray(mh), np.asarray(mp)
        x2, profile, gain = _renoise_input()
        r["renoise"] = np.asarray(js.renoise_sharded(
            mesh, jm.shard_time_batch(mesh, x2), profile, gain, N_FFT, STEP, "hann"))
        xh, gdb, _ = _heal_input()
        r["heal"] = np.asarray(js.heal_sharded(mesh, jm.shard_time_batch(mesh, xh), gdb,
                                               N_FFT, STEP))
        out[(nf, nt)] = r
    return out


def _ids(f):
    return f"{f[0]}x{f[1]}"


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_ranks_import_no_jax(worlds, f):
    assert worlds[1][f] == [[]] * (f[0] * f[1])


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_stft_sharded_matches_jax(worlds, jax_refs, f):
    got = worlds[0][f]["stft"]
    got = got[..., 0] + 1j * got[..., 1]
    want = jax_refs[f]["stft"]
    assert got.shape == want.shape == (2, N_FFT // 2 + 1, 8192 // STEP)
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_istft_sharded_round_trip(worlds, f):
    y = worlds[0][f]["istft"]
    x = 0.5 * _noise()
    sl = slice(N_FFT, 8192 - N_FFT)
    assert np.abs(y[:, sl] - x[:, sl]).max() < 1e-3


@pytest.mark.parametrize("mask", ["hpss_h", "hpss_p"])
@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_hpss_sharded_matches_jax(worlds, jax_refs, f, mask):
    np.testing.assert_allclose(worlds[0][f][mask], jax_refs[f][mask], atol=1e-5)


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_renoise_sharded_matches_jax(worlds, jax_refs, f):
    got, want = worlds[0][f]["renoise"], jax_refs[f]["renoise"]
    lo, hi = N_FFT, got.shape[1] - N_FFT
    np.testing.assert_allclose(got[:, lo:hi], want[:, lo:hi], atol=5e-4)
    assert np.std(got[0, lo:hi]) > 0.1  # the tone survives


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_heal_sharded_matches_jax_and_boosts(worlds, jax_refs, f):
    got = worlds[0][f]["heal"]
    np.testing.assert_allclose(got, jax_refs[f]["heal"], atol=5e-4)
    x, _, (d0, d1) = _heal_input()
    lo, hi = d0 + N_FFT, d1 - N_FFT
    assert 5.0 < np.std(got[0, lo:hi]) / np.std(x[0, lo:hi]) < 15.0
    q0, q1 = int(0.5 * SR), int(1.0 * SR)
    np.testing.assert_allclose(got[0, q0:q1], x[0, q0:q1], atol=5e-3)


@pytest.mark.parametrize("chain", ["cog", "adaptive"])
@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_sequential_chains_equal_the_dense_scans(worlds, f, chain):
    r = worlds[0][f]
    for b in range(2):
        np.testing.assert_allclose(r[chain][b], r[f"dense/{chain}{b}"], rtol=0, atol=0)
