"""The port's file-level batch restore and ``respeed-batch`` against the
JAX package on the CPU: the host helpers bit for bit, the written files by
the compacted-sample rule, flutter, grouping, the int32 cap and the CLI
(both tiers; the mesh worlds are in test_torch_mesh.py)."""

import json
import os

import numpy as np
import pytest
import torch

from pyaudiorestoration_tpu.parallel import batch as jb
from pyaudiorestoration_tpu.parallel import sharded as js
from pyaudiorestoration_tpu.utils import audio_io, metrics
from pyaudiorestoration_tpu_torch import cli
from pyaudiorestoration_tpu_torch.parallel import batch as tb
from pyaudiorestoration_tpu_torch.parallel import sharded as ts

torch.set_num_threads(2)

# test_sharded_fast.py's shapes
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


@pytest.fixture(scope="module")
def takes(tmp_path_factory):
    """Three wobbling takes of unequal length, one not a multiple of STEP."""
    d = tmp_path_factory.mktemp("takes")
    paths = []
    for i, (n, depth) in enumerate([(3 * SR + 77, 0.01), (2 * SR, 0.014),
                                    (int(2.5 * SR), 0.012)]):
        p = str(d / f"t{i}.wav")
        audio_io.write_wav(p, _wobble_take(n, depth, (1.1 + i, 4.7), 0.3 * i), SR)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def outputs(takes):
    return {
        "jax": jb.restore_batch_files_fused(takes, out_suffix="_j", backend="xla", **KW),
        "port": tb.restore_batch_files_fused(takes, out_suffix="_t", device="cpu", **KW),
        "port1": tb.restore_batch_files_fused(takes, out_suffix="_t1", device="cpu",
                                              n_files_axis=1, **KW),
    }


def _read(path):
    return audio_io.read_file(path)[0][:, 0]


# ---------------------------------------------------------------- host helpers

def test_unwrap_base_int_bit_equal():
    rng = np.random.default_rng(7)
    true = np.concatenate([[0], np.cumsum(rng.integers(0, 130, 200_000))])
    for bits in (32, 9):
        half = 1 << (bits - 1)
        wrapped = ((true + half) & ((1 << bits) - 1)) - half
        w2 = np.stack([wrapped[:1000], wrapped[1000:2000]]).astype(np.int32)
        frac = rng.random((2, 1000))
        for args in ((wrapped,), (w2,), (w2, frac)):
            got = ts.unwrap_base_int(*args, bits=bits)
            ref = js.unwrap_base_int(*args, bits=bits)
            assert got.dtype == ref.dtype and np.array_equal(got, ref)
        assert np.array_equal(ts.unwrap_base_int(wrapped, bits=bits), true)


def test_compact_padded_host_bit_equal():
    rng = np.random.default_rng(1)
    padded = rng.standard_normal((40, 13)).astype(np.float32)
    n = rng.integers(0, 14, 40)
    n[[0, 5, 6]] = 0
    for n_out in (None, int(n.sum()) - 7):
        assert np.array_equal(ts.compact_padded_host(padded, n, n_out),
                              js.compact_padded_host(padded, n, n_out))


@pytest.mark.parametrize("L,tail", [(100, 30), (100, 0), (10, 500), (1, 5), (0, 5)])
def test_reflect_continue_bit_equal(L, tail):
    row = np.random.default_rng(L).standard_normal(128).astype(np.float32)
    row[L:] = 0
    assert np.array_equal(tb.reflect_continue(row.copy(), L, tail),
                          jb.reflect_continue(row.copy(), L, tail))


def test_validate_plan_bit_equal_and_refuses_corrupt_plan():
    T, step = 64, 64
    bi = (np.arange(T) * step).astype(np.int64)
    bf = np.random.default_rng(0).random(T)
    assert np.array_equal(tb.validate_plan(bi, bf, step, T, slack=100),
                          jb.validate_plan(bi, bf, step, T, slack=100))
    bad = bi.copy()
    bad[40:] += 5000  # a skipped halo's worth of input
    with pytest.raises(RuntimeError, match="one-hop advance"):
        tb.validate_plan(bad, bf, step, T, slack=100)
    wrapped = (((bi + 256) & 511) - 256).astype(np.int32)  # wrapped at 2**9
    assert np.array_equal(tb.validate_plan(wrapped, bf, step, T, 100, wrap_bits=9),
                          jb.validate_plan(wrapped, bf, step, T, 100, wrap_bits=9))


def test_load_batch_bit_equal(takes):
    got = tb.load_batch(takes, multiple=STEP, reflect_tail=NFFT)
    ref = jb.load_batch(takes, multiple=STEP, reflect_tail=NFFT)
    assert np.array_equal(got[0], ref[0]) and got[1:] == ref[1:]


# ---------------------------------------------------------------- files

def test_one_output_per_input(takes, outputs):
    assert outputs["port"] == [p[:-4] + "_t.wav" for p in takes]
    assert all(os.path.isfile(p) for p in outputs["port"])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_files_match_jax(outputs, i):
    """Each take's file against JAX's mesh restore of it, by the
    compacted-sample rule (test_restore_fused.py:88-96)."""
    a, b = _read(outputs["port"][i]), _read(outputs["jax"][i])
    assert abs(len(a) - len(b)) <= 2
    m = min(len(a), len(b)) - 100
    err = np.abs(a[100:m] - b[100:m])
    assert np.median(err) < 1e-4 and (err > 1e-2).mean() < 0.01


@pytest.mark.parametrize("i", [0, 1, 2])
def test_flutter_falls_below_a_third(takes, outputs, i):
    """test_sharded_fast.py:198-223."""
    x, y = _read(takes[i]), _read(outputs["port"][i])
    assert abs(len(y) - len(x)) < 4 * STEP
    assert metrics.flutter(y, SR) < metrics.flutter(x, SR) / 3


def test_grouping_does_not_change_the_bytes(outputs):
    for a, b in zip(outputs["port"], outputs["port1"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_groups_split_at_the_int32_cap():
    """A rank holds as many takes of a group as keep its flattened signal
    under the int32 cap of the sinc's anchors; a take at the cap no longer
    raises: it raises the world to a mesh whose time shards stay under 2**30
    samples (the int64 plan)."""
    cap = 1 << 31
    assert tb._takes_per_rank(2, 10) == 2
    assert tb._takes_per_rank(8, cap // 3 + 1) == 2
    assert tb._takes_per_rank(8, cap // 2) == 1
    assert tb._takes_per_rank(8, cap - 1) == 1
    assert tb._world_size(1, cap) == 2
    assert tb._mesh_shape(2, 2, min_time=2) == (1, 2)


def test_restore_batch_files_fused_raises_for_cuda_without_card(takes):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tb.restore_batch_files_fused(takes, **KW)


# ---------------------------------------------------------------- CLI

def test_cli_respeed_batch_on_cpu(takes, capsys):
    rc = cli.main(["respeed-batch", *takes[:2], "--device", "cpu", "--f0", str(F0),
                   "--fft-size", str(NFFT), "--step", str(STEP), "--sinc-quality", "16"])
    assert rc == 0
    outs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert outs == [p[:-4] + "_res.wav" for p in takes[:2]]
    for p_in, p_out in zip(takes, outs):
        assert abs(len(_read(p_out)) - len(_read(p_in))) < 4 * STEP


def test_cli_respeed_batch_fixed_tier_not_ported(takes, capsys):
    """The fixed-length tier is ported: it writes one file of the input's
    length per take, and keeps the JAX CLI's --f0 requirement."""
    with pytest.raises(ValueError, match="--f0"):
        cli.main(["respeed-batch", takes[0], "--tier", "fixed", "--device", "cpu"])
    assert cli.main(["respeed-batch", *takes[:2], "--tier", "fixed", "--f0", "2048",
                     "--fft-size", str(NFFT), "--step", str(STEP), "--device", "cpu"]) == 0
    outs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["outputs"]
    assert outs == [p[:-4] + "_res.wav" for p in takes[:2]]
    for p_in, p_out in zip(takes, outs):
        assert len(_read(p_out)) == len(_read(p_in))

