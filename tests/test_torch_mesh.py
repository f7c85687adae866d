"""The port's mesh (``parallel/mesh.py``) and the file-level mesh entries of
``parallel/batch.py`` on the CPU, in worlds of gloo ranks.

One spawned world for each factorization (1x1, 1x2, 1x4, 2x2) runs the
collectives and writes each rank's results to an .npz file: the rank
layout against JAX's ``make_mesh``, the two ppermute directions with zeros
at the edge shards (``jax.lax.ppermute`` with a partial permutation), psum,
all_gather stacked and tiled, the two-way exchange, the carry chain, and
the scatter and gather of a (files, time) batch.  The launcher fails within
its limit when a rank raises or a world outlives it.  The file-level
entries (the fused batch over 2 and 4 ranks, the shared-curve file, the
tapesync export, the fixed-length tier) against JAX's by the
compacted-sample rule, flutter and their own invariants.  The ranks import
only the port and numpy."""

import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pyaudiorestoration_tpu_torch.parallel import batch as tb
from pyaudiorestoration_tpu_torch.parallel import mesh as tm
from pyaudiorestoration_tpu_torch.utils import audio_io

FACTORS = [(1, 1), (1, 2), (1, 4), (2, 2)]


def _batch(nf, nt):
    return np.arange(2 * nf * 4 * nt * 6, dtype=np.float32).reshape(2 * nf, 24 * nt)


def _world(dev, nf, nt, out_dir):
    mesh = tm.Mesh(nf, nt, dev)
    r = mesh.rank
    v = torch.full((2, 3), float(r + 1))
    res = {"coords": np.array([mesh.axis_index("files"), mesh.axis_index("time")]),
           "backend": np.array(mesh.backend)}
    for axis in ("time", "files"):
        res[f"right_{axis}"] = mesh.right_ppermute(v, axis).numpy()
        res[f"left_{axis}"] = mesh.left_ppermute(v, axis).numpy()
        res[f"psum_{axis}"] = mesh.psum(v, axis).numpy()
        res[f"gather_{axis}"] = mesh.all_gather(v, axis).numpy()
        res[f"tiled_{axis}"] = mesh.all_gather(v, axis, tiled=True).numpy()
    fl, fr = mesh.exchange("time", to_left=-v[:1], to_right=v)
    res["from_left"], res["from_right"] = fl.numpy(), fr.numpy()
    carry = mesh.recv_left(torch.tensor([10.0]))
    mesh.send_right(carry + 1)
    res["chain"] = carry.numpy()
    full = _batch(nf, nt)
    res["sliced"] = tm.shard_time_batch(mesh, full).numpy()
    scattered = tm.shard_time_batch(mesh, full if r == 0 else None, src=0)
    res["scattered"] = scattered.numpy()
    got = tm.gather_time_batch(mesh, scattered)
    res["gathered"] = got if r == 0 else np.zeros(0)
    np.savez(os.path.join(out_dir, f"{nf}x{nt}_r{r}.npz"), **res)
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "pyaudiorestoration_tpu"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_worlds")
    out = {}
    for nf, nt in FACTORS:
        loaded = tm.launch(_world, nf * nt, (nf, nt, str(d)), device="cpu", spawn=True,
                           timeout_s=300)
        out[(nf, nt)] = ([dict(np.load(d / f"{nf}x{nt}_r{r}.npz"))
                          for r in range(nf * nt)], loaded)
    return out


def _ids(f):
    return f"{f[0]}x{f[1]}"


def _coords(f, r):
    return r // f[1], r % f[1]


def _rank(f, files, time_):
    return files * f[1] + time_


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_layout_matches_jax_make_mesh(worlds, f):
    """Rank r holds the block at device r's place in JAX's mesh."""
    import jax

    from pyaudiorestoration_tpu.parallel import mesh as jm

    ids = np.vectorize(lambda d: d.id)(
        jm.make_mesh(f[0], f[1], devices=jax.devices()[:f[0] * f[1]]).devices)
    for r, res in enumerate(worlds[f][0]):
        assert tuple(np.argwhere(ids == r)[0]) == tuple(res["coords"])
        assert str(res["backend"]) == "gloo"
    assert worlds[f][1] == [[]] * (f[0] * f[1])


@pytest.mark.parametrize("axis", ["time", "files"])
@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_ppermute_edge_shards_receive_zeros(worlds, f, axis):
    ax = 1 if axis == "time" else 0
    n = f[ax]
    for r, res in enumerate(worlds[f][0]):
        c = list(_coords(f, r))
        i = c[ax]
        for key, peer, edge in (("right", i - 1, i == 0), ("left", i + 1, i == n - 1)):
            c2 = list(c)
            c2[ax] = peer
            want = 0.0 if edge else _rank(f, *c2) + 1.0
            np.testing.assert_array_equal(res[f"{key}_{axis}"], np.full((2, 3), want))


@pytest.mark.parametrize("axis", ["time", "files"])
@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_psum_and_all_gather(worlds, f, axis):
    ax = 1 if axis == "time" else 0
    for r, res in enumerate(worlds[f][0]):
        c = list(_coords(f, r))
        peers = []
        for i in range(f[ax]):
            c[ax] = i
            peers.append(_rank(f, *c) + 1.0)
        np.testing.assert_array_equal(res[f"psum_{axis}"], np.full((2, 3), sum(peers)))
        stacked = np.stack([np.full((2, 3), p) for p in peers])
        np.testing.assert_array_equal(res[f"gather_{axis}"], stacked)
        np.testing.assert_array_equal(res[f"tiled_{axis}"], stacked.reshape(-1, 3))


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_exchange_both_ways_and_chain(worlds, f):
    for r, res in enumerate(worlds[f][0]):
        files, t = _coords(f, r)
        left = 0.0 if t == 0 else _rank(f, files, t - 1) + 1.0
        right = 0.0 if t == f[1] - 1 else -(_rank(f, files, t + 1) + 1.0)
        np.testing.assert_array_equal(res["from_left"], np.full((2, 3), left))
        np.testing.assert_array_equal(res["from_right"], np.full((1, 3), right))
        np.testing.assert_array_equal(res["chain"], [10.0 + t])


@pytest.mark.parametrize("f", FACTORS, ids=_ids)
def test_scatter_and_gather_blocks(worlds, f):
    full = _batch(*f)
    bf, bt = full.shape[0] // f[0], full.shape[1] // f[1]
    for r, res in enumerate(worlds[f][0]):
        files, t = _coords(f, r)
        block = full[files * bf:(files + 1) * bf, t * bt:(t + 1) * bt]
        np.testing.assert_array_equal(res["sliced"], block)
        np.testing.assert_array_equal(res["scattered"], block)
    np.testing.assert_array_equal(worlds[f][0][0]["gathered"], full)


def _raise_on_rank_1(dev):
    mesh = tm.Mesh(1, 2, dev)
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.psum(torch.ones(1), "time")  # rank 0 waits for rank 1 here


def _sleep(dev):
    time.sleep(600)


def test_a_rank_that_raises_fails_the_world_in_time():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tm.launch(_raise_on_rank_1, 2, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_a_world_past_its_limit_is_ended():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="ran past 3"):
        tm.launch(_sleep, 2, device="cpu", timeout_s=3)
    assert time.monotonic() - t0 < 60


def _world_facts(dev):
    return dist.get_world_size(), dist.get_backend(), str(dev)


def test_one_rank_runs_in_this_process():
    assert tm.launch(_world_facts, 1, device="cpu") == [(1, "gloo", "cpu")]
    assert not dist.is_initialized()


def test_mesh_defaults_to_the_card():
    """A mesh's blocks live on the card unless the CPU is asked for: without
    a card the default raises, as every entry of the port does."""
    assert tm.Mesh(1, 1, "cpu").device == torch.device("cpu")
    assert tm.make_mesh(device="cpu").shape == {"files": 1, "time": 1}
    if not torch.cuda.is_available():
        for make in (tm.Mesh, tm.make_mesh):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                make()


def test_backends_and_ranks():
    assert tm.world_backend(4, "cpu") == "gloo"
    assert tm.world_ranks("cpu") == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tm.world_ranks("cuda")


@pytest.mark.parametrize("world,n_files,n_files_axis,min_time,want", [
    (4, 3, None, 1, (2, 2)), (4, 8, None, 1, (4, 1)), (4, 1, None, 1, (1, 4)),
    (8, 2, None, 1, (2, 4)), (4, 4, None, 2, (2, 2)), (6, 4, 3, 1, (3, 2)),
    (1, 5, None, 1, (1, 1))])
def test_mesh_shape(world, n_files, n_files_axis, min_time, want):
    assert tb._mesh_shape(world, n_files, n_files_axis, min_time) == want


def test_world_size_keeps_shards_under_the_cap():
    cap = tb._SHARD_CAP
    assert tb._world_size(1, cap) == 1
    assert tb._world_size(1, cap + 1) == 2
    assert tb._world_size(4, 3 * cap) == 4
    assert tb._world_size(2, 5 * cap + 7) == 6


# ---------------------------------------------------------------- files

SR = 16384
STEP, NFFT, ZP = 64, 256, 1
F0 = 2048.0
KW = dict(f0_hz=F0, tolerance_st=1.0, fft_size=NFFT, fft_overlap=NFFT // STEP,
          zeropad=ZP, sinc_quality=16, drift=16)


def _wobble_take(n, depth=0.01, rates=(1.3, 4.7), seed_phase=0.0):
    t = np.arange(n) / SR
    speed = 1.0 + sum(depth * (0.5 ** i) * np.sin(2 * np.pi * r * t + seed_phase + i)
                      for i, r in enumerate(rates))
    return np.sin(2 * np.pi * F0 * np.cumsum(speed) / SR).astype(np.float32)


def _read(path):
    return audio_io.read_file(path)[0]


def _compacted_close(a, b):
    assert abs(len(a) - len(b)) <= 2
    m = min(len(a), len(b)) - 100
    err = np.abs(a[100:m] - b[100:m])
    assert np.median(err) < 1e-4 and (err > 1e-2).mean() < 0.01


@pytest.fixture(scope="module")
def takes(tmp_path_factory):
    d = tmp_path_factory.mktemp("takes")
    paths = []
    for i, (n, depth) in enumerate([(3 * SR + 77, 0.01), (2 * SR, 0.014),
                                    (int(2.5 * SR), 0.012)]):
        p = str(d / f"t{i}.wav")
        audio_io.write_wav(p, _wobble_take(n, depth, (1.1 + i, 4.7), 0.3 * i), SR)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def fused_files(takes):
    from pyaudiorestoration_tpu.parallel import batch as jb

    return {"jax": jb.restore_batch_files_fused(takes, out_suffix="_j", backend="xla",
                                                **KW),
            2: tb.restore_batch_files_fused(takes, out_suffix="_r2", device="cpu",
                                            n_ranks=2, **KW),
            4: tb.restore_batch_files_fused(takes, out_suffix="_r4", device="cpu",
                                            n_ranks=4, **KW)}


@pytest.mark.parametrize("ranks", [2, 4])
def test_fused_batch_on_the_mesh_matches_jax(takes, fused_files, ranks):
    """Two ranks: a 2x1 mesh, two takes a rank (the last row is the third
    take again); four: a 2x2 mesh, each take sharded over two ranks."""
    from pyaudiorestoration_tpu.utils import metrics

    outs = fused_files[ranks]
    assert outs == [p[:-4] + f"_r{ranks}.wav" for p in takes]
    for p_in, p_out, p_j in zip(takes, outs, fused_files["jax"]):
        y = _read(p_out)[:, 0]
        _compacted_close(y, _read(p_j)[:, 0])
        x = _read(p_in)[:, 0]
        assert metrics.flutter(y, SR) < metrics.flutter(x, SR) / 3


def test_fused_batch_grouping_does_not_change_the_bytes(fused_files):
    for a, b in zip(fused_files[2], fused_files[4]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.fixture(scope="module")
def stereo(tmp_path_factory):
    d = tmp_path_factory.mktemp("stereo")
    sig = _wobble_take(4 * STEP * 1024)
    p = str(d / "take.wav")
    audio_io.write_wav(p, np.stack([sig, 0.6 * sig], -1), SR)
    return p


def test_restore_file_sharded_matches_jax(stereo):
    from pyaudiorestoration_tpu.parallel import batch as jb

    kw = dict(KW, backend="xla")
    out = tb.restore_file_sharded(stereo, out_suffix="_t", device="cpu", n_ranks=4, **kw)
    ref = jb.restore_file_sharded(stereo, out_suffix="_j", **kw)
    y, y_j = _read(out), _read(ref)
    assert y.shape[1] == 2
    for c in range(2):
        _compacted_close(y[:, c], y_j[:, c])
    np.testing.assert_allclose(y[:, 1], 0.6 * y[:, 0], atol=1e-5)


def test_restore_file_sharded_sizes_its_world(stereo, monkeypatch):
    """The world grows until no rank holds ``_SHARD_CAP`` samples of the
    padded channels (twice the take's decoded samples, a bound), so that a
    rank's flattened signal stays under the sinc's int32 cap; the cap is
    lowered here to the take's samples."""
    from pyaudiorestoration_tpu_torch.utils import streaming

    seen = []
    monkeypatch.setattr(tb, "run_in_world",
                        lambda fn, n_ranks, args, device: seen.append(n_ranks))
    monkeypatch.setattr(tb, "_SHARD_CAP", streaming.decoded_bytes(stereo) // 4)
    for n_ranks in (None, 1, 4):
        tb.restore_file_sharded(stereo, device="cpu", n_ranks=n_ranks, **KW)
    assert seen == [2, 2, 4]


def test_lag_resample_file_sharded_shifts_every_channel(tmp_path):
    n = 4 * STEP * 1024
    sig = np.sin(2 * np.pi * 440 * np.arange(n) / SR).astype(np.float32)
    p = str(tmp_path / "src.wav")
    audio_io.write_wav(p, np.stack([sig, 0.5 * sig], -1), SR)
    lag = 25.0 / SR
    out = tb.lag_resample_file_sharded(p, [0.0, n / SR], [lag, lag], hop=STEP,
                                       sinc_quality=16, drift=8, device="cpu", n_ranks=2)
    y = _read(out)
    assert y.shape == (n, 2)
    h = 4096
    np.testing.assert_allclose(y[h:-h, 0], sig[h - 25:-h - 25], atol=1e-4)
    np.testing.assert_allclose(y[:, 1], 0.5 * y[:, 0], atol=1e-5)


def test_fixed_tier_files_restore(tmp_path):
    """``restore_batch_files`` (``respeed-batch --tier fixed``) on a 2x1 mesh:
    outputs of the input lengths, flutter under half the input's
    (test_sharded.py:71-101)."""
    sr = 8192
    paths = []
    for i in range(3):
        n = 4 * sr - 1000 * i
        t = np.arange(n) / sr
        speed = 1.0 + 0.02 * np.sin(2 * np.pi * (2.0 + 0.3 * i) * t)
        p = str(tmp_path / f"f{i}.wav")
        audio_io.write_wav(p, np.sin(2 * np.pi * 1024 * np.cumsum(speed) / sr)
                           .astype(np.float32), sr)
        paths.append(p)
    outs = tb.restore_batch_files(paths, 1024.0, n_fft=512, step=128, device="cpu",
                                  n_ranks=2)
    assert outs == [p[:-4] + "_res.wav" for p in paths]
    from pyaudiorestoration_tpu.utils import metrics

    for p_in, p_out in zip(paths, outs):
        x, y = _read(p_in)[:, 0], _read(p_out)[:, 0]
        assert len(y) == len(x) and np.all(np.isfinite(y))
        assert metrics.flutter(y, sr) < 0.5 * metrics.flutter(x, sr)
