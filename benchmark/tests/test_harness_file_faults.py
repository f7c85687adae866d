"""The file cell's check fails each fault its timed path can have: the
output file left unwritten, one written sample altered by +0.01, the stream
cut 100 samples short, the stream planned by the fused entries' float32
rule (the clipped curve, float32 dither, no end trim) in place of the file
path's float64 one, and every channel resampled with TF32 products.  Each
runs ``tiny.f3`` on the CPU with the fault planted in the program, once
under the tiny file limits and once under each file cell's limits file; a
sound run passes both."""

import json
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, TINY_FILE_LIMITS, make_tiny_file_bench

from benchmark.lib import harness
from benchmark.reference import restore
from benchmark.reference.file_restore import file_plan
from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt
from pyaudiorestoration_tpu_torch.utils import audio_io

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
FILE_CELLS = [w["name"] for w in SPEC["workloads"]
              if json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
              .get("pipeline") == "file_fast"]
SEED = 2 ** 31 + 12345
DRIFT = 16  # the configurations' fused plan clips the curve by this drift bound


def run(bench_spec):
    bench, spec = bench_spec
    result, checks, _ = harness.run_cell("tiny.f3", SEED, 0.5, False, t0=time.perf_counter(),
                                         bench_dir=bench, device="cpu", spec=spec)
    return result, checks


def unwritten(fn):
    def broken(audio_path, signal, sr, channels=None, suffix="_out"):
        return f"{audio_path.rsplit('.', 1)[0]}{suffix}.wav"
    return broken


def altered(fn):
    def broken(audio_path, signal, *a, **k):
        signal = np.array(signal)
        signal[len(signal) // 2, 0] += 0.01
        return fn(audio_path, signal, *a, **k)
    return broken


def cut_short(fn):
    def broken(audio_path, signal, *a, **k):
        return fn(audio_path, signal[:-100], *a, **k)
    return broken


def fused_plan(speeds_np, hop: int):
    """The fused entries' plan of a host speed curve, as their reference
    makes it: the clipped curve, float32 raw counts, no end trim."""
    pl = restore.plan(torch.as_tensor(np.asarray(speeds_np, np.float32)), hop, int(hop * 1.1),
                      DRIFT)
    return pl["n"].numpy(), pl["base"].numpy()


def fused_rule(fn):
    def broken(speeds_np, hop, num_input_samples, t0_samples=0.0):
        plan = fn(speeds_np, hop, num_input_samples, t0_samples)
        n, base = fused_plan(speeds_np, hop)
        base_int = np.floor(base).astype(np.int32)
        plan.update(n=n.astype(np.int32), base_int=base_int,
                    base_frac=(base - base_int).astype(np.float32),
                    starts=np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64),
                    max_n=int(n.max()), n_out=int(n.sum()))
        return plan
    return broken


def tf32_resample(fn):
    """The resample of the program's own plan computed by the reference with
    its products' operands rounded to TF32."""
    def broken(sig, speeds, n, base_int, base_frac, max_n, nt, drift, backend="auto"):
        f64 = torch.float64
        pl = {"s_lo": speeds[:-1].to(f64), "s_hi": speeds[1:].to(f64), "n": n.to(torch.int64),
              "base": base_int.to(f64) + base_frac.to(f64), "max_n": max_n}
        x = sig if sig.dim() == 2 else sig[None]
        out = torch.stack([restore.sinc_rows(ch.to(f64), pl, 0, n.shape[0], nt,
                                             tf32_products=True).to(torch.float32) for ch in x])
        return out if sig.dim() == 2 else out[0]
    return broken


FAULTS = {unwritten: (audio_io, "write_file"), altered: (audio_io, "write_file"),
          cut_short: (audio_io, "write_file"), fused_rule: (rt, "plan_positions_fast"),
          tf32_resample: (rt, "run_banded_sinc")}


def test_the_fused_rule_plans_this_pool_otherwise(tmp_path):
    """The fault has something to show: on this seed's takes the fused rule's
    counts or length differ from the file path's."""
    bench, spec = make_tiny_file_bench(tmp_path)
    c = harness.cell_files(bench, spec, "tiny.f3")
    pool = c.pipeline.make_pool(c.cfg, c.traffic, SEED, torch.device("cpu"), tmp_path / "files")
    params = c.pipeline.params(pool, c.cfg)
    differ = 0
    for item in pool:
        ref = c.pipeline.reference(item["x"], params, torch.device("cpu"))
        speeds = torch.cat([ref.plans[1]["s_lo"], ref.plans[1]["s_hi"][-1:]]).to(torch.float32)
        n, _ = fused_plan(speeds.numpy(), params["hop"])
        ours = file_plan(speeds, params["hop"], item["x"].shape[1])
        differ += int(not np.array_equal(n, ours["n"].numpy()) or n.sum() != ours["n_out"])
    assert differ >= 1


@pytest.mark.parametrize("limits_of", [None] + FILE_CELLS)
@pytest.mark.parametrize("fault", list(FAULTS), ids=lambda f: f.__name__)
def test_file_fault_is_not_correct(tmp_path, monkeypatch, limits_of, fault):
    limits = TINY_FILE_LIMITS if limits_of is None else json.loads(
        (BENCH / "limits" / f"{limits_of}.json").read_text())
    bench = make_tiny_file_bench(tmp_path, limits)
    mod, name = FAULTS[fault]
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    result, checks = run(bench)
    assert not result["correct"], checks
    assert any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("limits_of", [None] + FILE_CELLS)
def test_sound_file_run_is_correct(tmp_path, limits_of):
    limits = TINY_FILE_LIMITS if limits_of is None else json.loads(
        (BENCH / "limits" / f"{limits_of}.json").read_text())
    result, checks = run(make_tiny_file_bench(tmp_path, limits))
    assert result["correct"] and result["failed"] == 0, checks
