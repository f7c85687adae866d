"""The plain reference against the port's CPU path at a small size, its
TF32 controls against the cells' limits, and the comparison's reading of a
grid."""

import json

import numpy as np
import pytest
import torch
from conftest import BENCH, tiny_config

from benchmark.lib import takes
from benchmark.reference import compare
from benchmark.reference.restore import Reference, log2_speeds, speeds_for, tf32, track


def take_and_params(cfg, seconds, seed=31337):
    traffic = {"layout": "take", "take_seconds": [seconds], "pool": 1}
    pool = takes.make_pool(cfg, traffic, seed, torch.device("cpu"))
    return pool[0]["x"], takes.plan_params(pool[0]["x"][0], cfg)


def port_grid(x, p):
    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    n = x.shape[1] // p["hop"] + 1
    NL = torch.full((n,), p["NL"], dtype=torch.int32)
    NU = torch.full((n,), p["NU"], dtype=torch.int32)
    return rt.restore_fused_device(x, NL, NU, p["fft_size"], p["hop"], p["zeropad"],
                                   p["max_n"], nt=p["nt"], drift=p["drift"],
                                   window_name=p["window"], backend="auto", band=p["band"],
                                   device="cpu").numpy(), NL, NU


def test_reference_follows_the_port_on_the_cpu():
    x, p = take_and_params(tiny_config(), 3.0)
    grid, NL, NU = port_grid(x, p)
    ref = Reference(x, p, torch.device("cpu"))
    verdict = compare.judge(grid, ref)
    assert verdict["residual_gap"] < 1e-4 and verdict["timing_gap"] < 1e-3, verdict

    from pyaudiorestoration_tpu_torch.pipelines import respeeder_device as rt

    speeds = rt.track_speed_device(torch.as_tensor(x[0]), NL, NU, p["fft_size"], p["hop"],
                                   p["zeropad"], p["window"], band=p["band"])
    ls = log2_speeds(track(torch.as_tensor(x[0]), p["NL"], p["NU"], p["band"], p))
    from benchmark.reference.restore import centre_candidates

    cands = [speeds_for(ls, m) for m in centre_candidates(ls, p["band"])]
    assert any(torch.equal(speeds, c) for c in cands)


@pytest.mark.parametrize("cell, stages, seconds", [
    pytest.param(cell, stages, seconds, id=f"{cell}-{'-'.join(stages)}")
    for cell, stages, seconds in [
        ("tape192.take30", ("track", "sinc"), None),
        ("cassette44.take240", ("track", "sinc"), None),
        ("tape192.take30", ("sinc",), 8),
        ("cassette44.take240", ("sinc",), 8),
        ("tape192.batch8", ("sinc",), 8),
        ("tape192.side10m", ("sinc",), 8)]])
def test_control_fails_the_cell_limit(cell, stages, seconds):
    """The reference with TF32 products in the program's place reads over
    the cell's limit: with TF32 in every product, on one take of the cell's
    own configuration and length (the curve's error grows with the take:
    2 s read 4e-4 to 7e-4, 8 s 4e-4 to 0.5); with TF32 in the sinc alone,
    whose root mean square residual is the same on any length, on 8 s."""
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell_spec = next(w for w in spec["workloads"] if w["name"] == cell)
    config = cell_spec["config"]
    traffic = json.loads((BENCH / "traffic" / f"{cell_spec['traffic']}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    x, p = take_and_params(cfg, seconds or traffic["take_seconds"][0])
    dev = torch.device("cpu")
    control = Reference(x, p, dev, tf32_in=stages).program_grids()
    verdict = compare.judge(control, Reference(x, p, dev))
    assert any(verdict[k] > limit for k, limit in limits.items()), verdict


def test_tf32_rounds_to_ten_mantissa_bits_to_nearest_even():
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + 3 * ulp / 2, one + ulp / 4, -(one + 0.75 * ulp),
                      3.0e-30], dtype=torch.float32)
    want = torch.tensor([one, one + 2 * ulp, one, -(one + ulp), 0.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:4], want[:4])
    assert abs(float(got[4]) - 3.0e-30) / 3.0e-30 <= 2.0 ** -11


def test_counts_read_from_a_grid():
    """A dither flip moves a sample between neighbouring rows; a row whose
    last samples are zero reads short with no neighbour long."""
    n_ref = np.array([4, 4, 4, 4, 4])
    grid = np.zeros((5, 6), np.float32)
    for i, n in enumerate([4, 3, 5, 4, 4]):
        grid[i, :n] = 1.0
    grid[4, 2:4] = 0.0  # row 4's last two samples are zero
    assert list(compare.counts_from_grid(grid, n_ref)) == [4, 3, 5, 4, 4]
    grid2 = grid.copy()
    grid2[1, :4], grid2[2, 4] = 1.0, 0.0  # no flip: row 1 full again, row 2 back to 4
    assert list(compare.counts_from_grid(grid2, n_ref)) == [4, 4, 4, 4, 4]


def test_stream_gap_counts_missing_samples():
    a = np.array([0.5, -0.25, 0.125])
    assert compare.stream_gap(a, a.copy())[0] == 0.0
    assert compare.stream_gap(a[:2], a) == (0.125, 2 / 3)
    assert compare.stream_gap(a + 1e-3, a)[0] == pytest.approx(1e-3)
